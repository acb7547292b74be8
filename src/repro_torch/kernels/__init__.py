"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

- ``sketch_update``: the SpaceSaving± bank updates (fused, banked
  residual, single-sketch residual, serial);
- ``flash_attention``: blocked online-softmax GQA attention with causal
  and sliding-window masks;
- ``decode_attention``: one-token GQA attention over a budgeted cache,
  with the per-slot attention mass.
"""
