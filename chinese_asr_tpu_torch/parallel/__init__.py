"""Multi-device decoding and training on torch.distributed (port of
``chinese_asr_tpu/parallel``): ``sharding`` builds the (data x model) mesh,
shards the parameters and batches and holds the collectives; ``launch``
spawns a group of ranks on one host; ``dryrun`` checks a mesh against one
device."""
