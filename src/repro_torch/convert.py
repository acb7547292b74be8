"""State carried between the reference package and the port.

The interchange is the reference's ``api.save`` dict: numpy arrays
with the integer ``layout`` tag (``repro/sketch/api.py:450, :497``),
for the frequency kind (plain, sharded, and the multi-tenant bank with
its ``tenants``/``shards``/``item_bits``), the quantile kind (with its
``mass``), the family's two banks (layout 3: ``_del`` fields, the key,
``family`` 1 double or 2 unbiased), CR-precis (layout 4: ``counts`` and
``primes``), and a tenant's spill dict (``tenant.spill_rows``: its
(S, k) rows of composite keys, read as an S-shard bank). Both packages
save and restore those layouts, so a checkpoint written by either loads
in the other and both compute the same thing from it.

The model side carries trees: ``params_from_reference`` takes the
reference's param tree (nested dicts of numpy arrays, as
``jax.tree.map(np.asarray, params)`` gives them) and returns the port's,
the same leaves bit for bit; ``cache_from_reference`` does the same for
a decode cache tree (with its ``pos``). A bf16 leaf arrives as numpy's
``bfloat16`` extension dtype, which ``torch.from_numpy`` refuses: it is
carried as its 16-bit pattern.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from .platform import DEFAULT_DEVICE
from .sketch import api
from .sketch.api import LAYOUT_CRPRECIS, LAYOUT_DOUBLE, SketchSpec
from .sketch.family import _primes_descending, crprecis_depth
from .sketch.state import BLOCKED


def spec_for(d: Dict[str, Any], variant: str = "sspm",
             bits: Optional[int] = None) -> SketchSpec:
    """The spec whose layout a checkpoint dict holds.

    The dict does not record the variant or the sizing (the state is the
    same for both variants), so the caller names the variant. A
    quantile dict (tagged so, or untagged with a ``mass``) gives
    ``kind="quantile"`` with ``bits`` its layer count and ``k`` one
    shard's live counters; a tenant dict gives ``tenants``, ``bits``
    its ``item_bits`` and ``k`` its live counters; another frequency
    dict gives ``k`` its slot count and the caller's ``bits`` (a spill
    dict's ``item_bits`` where the caller names none). A family dict
    (tag 3) gives the variant its ``family`` field names and ``k`` the
    live counters of both banks; a CR-precis dict (tag 4) gives ``k`` the
    least budget whose primes are the dict's.
    """
    tag = int(np.asarray(d["layout"])) if "layout" in d else None
    if tag == LAYOUT_CRPRECIS:
        primes = [int(p) for p in np.asarray(d["primes"])]
        t = len(primes)
        # t rows need a budget of at least 64 for t = 4 (crprecis_depth)
        k = max(t * primes[0], 64 if t == 4 else 0)
        if crprecis_depth(k) != t or _primes_descending(k // t, t) != primes:
            raise ValueError(f"no counter budget gives the moduli {primes}")
        return api.infer_spec(SketchSpec(k=k, bits=bits), d)
    ids = np.asarray(d["ids"])
    shards = int(np.asarray(d["shards"])) if "shards" in d else None
    if bits is None and "item_bits" in d:
        bits = int(np.asarray(d["item_bits"]))
    if tag == LAYOUT_DOUBLE:
        live = int((ids != BLOCKED).sum()
                   + (np.asarray(d["ids_del"]) != BLOCKED).sum())
        tenants = int(np.asarray(d["tenants"])) or None
        spec = SketchSpec(k=live, variant=variant, shards=shards or None,
                          bits=bits or None, tenants=tenants)
        return api.infer_spec(spec, d)
    if d.get("tenants") is not None:
        spec = SketchSpec(k=int((ids != BLOCKED).sum()), variant=variant,
                          shards=shards or None, bits=bits,
                          tenants=int(np.asarray(d["tenants"])))
        return api.infer_spec(spec, d)
    probe = api.infer_spec(SketchSpec(k=1, bits=bits), d)
    if probe.kind == "quantile":
        k = int((ids != BLOCKED).sum()) // (shards or 1)
        spec = SketchSpec(kind="quantile", k=k, variant=variant,
                          shards=shards or None, bits=ids.shape[-2])
    else:
        spec = SketchSpec(k=int(ids.size), variant=variant,
                          shards=shards or None, bits=bits)
    return api.infer_spec(spec, d)


def to_port(d: Dict[str, Any], spec: Optional[SketchSpec] = None,
            device=DEFAULT_DEVICE) -> Tuple[SketchSpec, Any]:
    """(spec, port state) from a checkpoint dict of either package."""
    spec = spec_for(d) if spec is None else api.infer_spec(spec, d)
    return spec, api.restore(spec, d, device)


def to_reference(spec: SketchSpec, state) -> Dict[str, Any]:
    """The tagged dict the reference's ``api.restore`` reads."""
    return api.save(spec, state)


def _leaf_to_port(a, device) -> "torch.Tensor":
    """One numpy leaf as a tensor on ``device``, bit for bit (bf16 through
    its 16-bit pattern)."""
    import torch

    a = np.array(a)            # a writable copy: jax's arrays are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _tree_to_port(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_port(v, device) for k, v in tree.items()}
    return _leaf_to_port(tree, device)


def params_from_reference(params: Dict[str, Any], cfg,
                          device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """The port's param tree from the reference's (numpy leaves), on
    ``device``. Raises where the tree's paths or shapes are not the ones
    ``models.transformer.init_params`` gives ``cfg``."""
    from .models.transformer import init_params
    from .platform import resolve_device

    dev = resolve_device(device)
    want, _ = init_params(None, cfg, device="meta")
    got = _tree_to_port(params, dev)

    def paths(tree, prefix=""):
        if isinstance(tree, dict):
            return {p: s for k, v in tree.items()
                    for p, s in paths(v, f"{prefix}/{k}").items()}
        return {prefix: tuple(tree.shape)}

    if paths(got) != paths(want):
        raise ValueError(f"the param tree does not fit {cfg.name}: "
                         f"{sorted(set(paths(got).items()) ^ set(paths(want).items()))[:8]}")
    return got


def cache_from_reference(cache: Dict[str, Any],
                         device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """The port's decode cache tree from the reference's (numpy leaves,
    with ``pos``), on ``device``, bit for bit."""
    from .platform import resolve_device

    return _tree_to_port(cache, resolve_device(device))


__all__ = ["spec_for", "to_port", "to_reference", "params_from_reference",
           "cache_from_reference"]
