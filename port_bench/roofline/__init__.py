"""The operations and bytes of each kernel's work and of the model's
step, from the shapes of their inputs and outputs, and the peaks they
are priced against (``peaks.json``).  A kernel that replaces one of them
is priced on the same work."""
