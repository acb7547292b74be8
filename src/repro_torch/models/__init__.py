"""The model stack of the port: layers, MoE, Mamba2 (SSD), the unified
transformer and the ``build_model`` facade (``repro/models`` in the JAX
package). Attention runs on the port's kernels 5 and 6."""
from .model import Model, build_model
from .transformer import forward, init_params, loss_fn, prefill_forward

__all__ = ["Model", "build_model", "forward", "init_params", "loss_fn",
           "prefill_forward"]
