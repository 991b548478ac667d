"""Training (port of ``chinese_asr_tpu/train``): the teacher-forced step,
optimizers and LR control, the trainer loop and its CLI."""
