"""The port's train step (``repro_torch/train/step.py``) against the
reference's (``repro/train/step.py``) on the ten smoke configs, f32
params drawn in the reference's tree (``test_torch_transformer.
reference_params``) and carried over with ``convert.params_from_
reference``; the reference runs with ``unroll_scan`` (its ``lax.scan``
refuses the f32 residual carry).

Tolerances. The loss is held at rtol 1e-5. Each gradient leaf is held
within 1e-4 of its largest |g|, except where a bf16 value lies on its
path in both packages: the embedding and the unembedding (both cast to
bf16 in the forward, so their cotangents are rounded to bf16) and the
first layer of the stack and of Whisper's encoder (it reads the bf16
embedding stream: its norm's output and cotangent are bf16). Those are
held within 2^-7 of the leaf's largest |g|, one bf16 rounding: the two
frameworks' f32 results differ in the last place and a bf16 rounding
then falls the other way. After one AdamW step (default config: lr
3e-4, clip 1.0), m and v are held as the gradient (v at twice the
share, v being a square) against the reference's own m and v, and the
master weights and params within lr·2^-7: a step moves a weight by
lr·mh/(sqrt(vh) + eps), about lr whatever the gradient's size at step 1,
so where the reference's gradient lies within its tolerance of 0 the
sign may fall either way and the two steps may differ by 2·lr there.
``microbatches=2`` is held the same way, against the reference's
step computed from its slices' jitted gradients (``_ref_microbatch_
step``: one compile for both slices, where its jitted
``build_train_step(microbatches=2)`` compiles the whole unrolled step;
``test_reference_microbatch_step_is_its_slices_then_adamw`` holds the
two within one f32 rounding). ``remat=True`` equals
``remat=False`` bit for bit. Also: the abstract state's shapes and
dtypes, and the grad guard of the kernel wrappers (a wrapper refuses
operands that require grad before it looks at their device; ``_attend``
on CPU tensors takes the plain path).

An architecture's configs, params (both packages'), batch and the
reference's loss and gradients are made once for the module (``cases``)
and shared by its parametrized tests; every function under test leaves
them as they were. The reference's one-step state is its gradients
through its own ``adamw_update`` (``_ref_step``): its ``build_train_step``
is exactly that, and ``test_reference_step_is_its_grads_then_adamw``
holds the two bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs under xdist; do not oversubscribe

from jax_executables import free_jax_executables  # noqa: F401
import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import build_model as jbuild
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.train import step as JS
from repro_torch import configs as tconfigs
from repro_torch.models import build_model as tbuild
from repro_torch.train import step as TS
from test_torch_transformer import _cfgs, _f32, _flat, _inputs, \
    reference_params

B, S = 2, 32
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2.0**-7
LR = 3e-4
FIRST_LAYER = ("/periods/pos0/", "/encoder/layers/")


def _batch(jcfg, seed=1):
    jb, tb = _inputs(jcfg, seed)
    labels = np.random.default_rng(seed + 100).integers(
        0, jcfg.vocab_size, tuple(tb["tokens"].shape)).astype(np.int32)
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    return jb, tb


def _pieces(path):
    """(index, tolerance as a share of the leaf's largest |g|) pieces of
    one leaf (see the module docstring)."""
    if path in ("/embed", "/unembed"):
        return [(slice(None), BF16_TOL)]
    if path.startswith(FIRST_LAYER):
        return [(slice(0, 1), BF16_TOL), (slice(1, None), GRAD_TOL)]
    return [(slice(None), GRAD_TOL)]


def _hold(label, got_tree, want_tree, scale_tree=None, factor=1.0):
    """Every leaf of ``got_tree`` within its pieces' tolerances times
    ``factor`` of the largest |leaf| of ``scale_tree`` (default: the
    wanted leaf)."""
    got, want = _flat(got_tree), _flat(jax.tree.map(np.asarray, want_tree))
    scales = want if scale_tree is None else _flat(
        jax.tree.map(np.asarray, scale_tree))
    assert set(got) == set(want), label
    for path, w in want.items():
        g = got[path]
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), path
        scale = float(np.abs(_f32(scales[path])).max())
        err = np.abs(_f32(g) - _f32(w))
        for index, tol in _pieces(path):
            worst = float(err[index].max()) if err[index].size else 0.0
            assert worst <= tol * factor * scale, \
                f"{label} {path}: {worst} > {tol * factor} x {scale}"


def _ref_grads(jcfg, jp, jb):
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jbuild(jcfg).loss(p, b), has_aux=True))(jp, jb)
    return loss, aux, grads


@pytest.fixture(scope="module")
def cases():
    """arch -> (jcfg, tcfg, jp, tp, jb, tb, the reference's (loss, aux,
    grads)), made at first use."""
    made = {}

    def get(arch):
        if arch not in made:
            jcfg, tcfg = _cfgs(arch)
            jp, tp = reference_params(jcfg, tcfg)
            jb, tb = _batch(jcfg)
            made[arch] = (jcfg, tcfg, jp, tp, jb, tb,
                          _ref_grads(jcfg, jp, jb))
        return made[arch]

    return get


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_loss_and_gradients(cases, arch):
    jcfg, tcfg, jp, tp, jb, tb, (wl, waux, wg) = cases(arch)
    gl, gaux, gg = TS.loss_and_grads(tbuild(tcfg), tp, tb, True, "kernel")
    np.testing.assert_allclose(float(gl), float(wl), rtol=LOSS_TOL)
    np.testing.assert_array_equal(gaux["expert_counts"].numpy(),
                                  np.asarray(waux["expert_counts"]))
    _hold(f"{arch} grads", gg, wg)


def _ref_state(jp):
    return JS.TrainState(params=jp, opt=j_adamw_init(jp))


def _ref_step(jp, ref_grads):
    """The reference's one-step (state, metrics) from its loss and
    gradients: ``build_train_step``'s ``microbatches=1`` body, its
    ``adamw_update`` at the default config on them."""
    loss, aux, grads = ref_grads
    params, opt, metrics = jax.jit(j_adamw_update)(grads, j_adamw_init(jp),
                                                   jp)
    return JS.TrainState(params=params, opt=opt), {
        "loss": loss.astype(jnp.float32),
        "expert_counts": aux["expert_counts"], **metrics}


def _port_state(tp):
    return TS.TrainState(params=tp, opt=TS.adamw_init(tp))


def _hold_step(label, got, want, gm, wm):
    """One step's state and metrics (see the module docstring). The
    reference's m after one step is (1 - b1) times its clipped gradient:
    the scale of m, v and of the gradients near 0."""
    np.testing.assert_allclose(float(gm["loss"]), float(wm["loss"]),
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(float(gm["grad_norm"]),
                               float(wm["grad_norm"]), rtol=BF16_TOL)
    np.testing.assert_allclose(float(gm["lr"]), float(wm["lr"]), rtol=1e-7)
    np.testing.assert_array_equal(gm["expert_counts"].numpy(),
                                  np.asarray(wm["expert_counts"]))
    assert int(got.opt.step) == int(want.opt.step) == 1
    _hold(f"{label} m", got.opt.m, want.opt.m)
    _hold(f"{label} v", got.opt.v, want.opt.v, factor=2)
    g = jax.tree.map(np.asarray, want.opt.m)
    # a weight moves by about lr at step 1 whatever its gradient's size
    # (mh / sqrt(vh) = sign(g)): where the reference's gradient lies
    # within the gradient tolerance of 0, rounding may set the sign
    # either way and the two steps differ by up to 2 lr
    gflat = _flat(g)
    for name, gt, wt in (("master", got.opt.master, want.opt.master),
                         ("params", got.params, want.params)):
        gf, wf = _flat(gt), _flat(jax.tree.map(np.asarray, wt))
        for path, w in wf.items():
            err = np.abs(_f32(gf[path]) - _f32(w))
            gw = np.abs(gflat[path])
            limit = np.full(gw.shape, LR * BF16_TOL, np.float32)
            for index, tol in _pieces(path):
                limit[index] = np.where(gw[index] <= tol * gw.max(),
                                        2.02 * LR, LR * BF16_TOL)
            worst = float((err - limit).max())
            assert worst <= 0, f"{label} {name} {path}: {worst} past it"


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_one_train_step(cases, arch):
    jcfg, tcfg, jp, tp, jb, tb, ref_grads = cases(arch)
    want, wm = _ref_step(jp, ref_grads)
    got, gm = TS.build_train_step(tcfg)(_port_state(tp), tb)
    _hold_step(arch, got, want, gm, wm)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "olmoe_1b_7b"])
def test_reference_step_is_its_grads_then_adamw(cases, arch):
    """What ``_ref_step`` stands on: the reference's jitted
    ``build_train_step`` equals its gradients through its jitted
    ``adamw_update``, bit for bit, state and metrics."""
    jcfg, _, jp, _, jb, _, ref_grads = cases(arch)
    want, wm = jax.jit(JS.build_train_step(jcfg))(_ref_state(jp), jb)
    got, gm = _ref_step(jp, ref_grads)
    for a, b in zip(jax.tree.leaves((want, wm)), jax.tree.leaves((got, gm))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(wm) == set(gm)


def _ref_microbatch_step(jcfg, jp, jb, M=2):
    """The reference's ``build_train_step(microbatches=M)`` (its
    ``unroll_scan`` body): each slice's loss and gradient from one jitted
    ``value_and_grad`` (one compile for the M slices), summed in f32 over
    M as the body sums them, then ``_ref_step``'s ``adamw_update`` (a
    compile ``test_one_train_step`` already made)."""
    vg = jax.jit(jax.value_and_grad(lambda p, b: jbuild(jcfg).loss(p, b),
                                    has_aux=True))
    acc = jax.jit(lambda c, l, a, g, e: (
        jax.tree.map(lambda x, y: x + y.astype(jnp.float32) / M, c, g),
        l + a / M, e))
    grads = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), jp)
    loss = jnp.zeros((), jnp.float32)
    counts = jnp.zeros((max(jcfg.num_experts, 1),), jnp.int32)
    for i in range(M):
        part = jax.tree.map(
            lambda x: x.reshape((M, x.shape[0] // M) + x.shape[1:])[i], jb)
        (l, aux), g = vg(jp, part)
        grads, loss, counts = acc(grads, loss, l, g,
                                  counts + aux["expert_counts"])
    return _ref_step(jp, (loss, {"expert_counts": counts}, grads))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_two_microbatches(cases, arch):
    jcfg, tcfg, jp, tp, jb, tb, _ = cases(arch)
    want, wm = _ref_microbatch_step(jcfg, jp, jb)
    got, gm = TS.build_train_step(tcfg, microbatches=2)(_port_state(tp), tb)
    _hold_step(f"{arch} microbatches=2", got, want, gm, wm)


@pytest.mark.parametrize("arch", ["qwen3_0_6b"])
def test_reference_microbatch_step_is_its_slices_then_adamw(cases, arch):
    """What ``_ref_microbatch_step`` stands on: the reference's jitted
    ``build_train_step(microbatches=2)`` equals its slices' gradients
    summed and then its ``adamw_update``, within one f32 rounding of
    each leaf's largest value (the one jit fuses the sum the other
    runs apart), on the cheapest config to compile."""
    jcfg, _, jp, _, jb, _, _ = cases(arch)
    want, wm = jax.jit(JS.build_train_step(jcfg, microbatches=2))(
        _ref_state(jp), jb)
    got, gm = _ref_microbatch_step(jcfg, jp, jb)
    assert set(wm) == set(gm)
    for a, b in zip(jax.tree.leaves((want, wm)), jax.tree.leaves((got, gm))):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=float(
            np.finfo(np.float32).eps * max(np.abs(_f32(a)).max(), 1e-30)))


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "olmoe_1b_7b", "zamba2_7b",
                                  "gemma3_27b"])
def test_remat_is_bit_for_bit(arch):
    _, tcfg = _cfgs(arch)
    tcfg = dataclasses.replace(tcfg, num_layers=2 * len(
        tcfg.layer_pattern()[0]))
    tp, _ = tbuild(tcfg).init(3, dtype=torch.float32, device="cpu")
    _, tb = _batch(jconfigs.get_smoke(arch))
    model = tbuild(tcfg)
    outs = [TS.loss_and_grads(model, tp, tb, remat, "kernel")
            for remat in (True, False)]
    assert torch.equal(outs[0][0], outs[1][0])
    a, b = _flat(outs[0][2]), _flat(outs[1][2])
    assert set(a) == set(b)
    for path in a:
        assert torch.equal(a[path], b[path]), path


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_abstract_state_shapes(arch):
    want, want_axes = JS.abstract_state(jconfigs.get_smoke(arch))
    got, got_axes = TS.abstract_state(tconfigs.get_smoke(arch))
    wf = _flat(want._asdict() | {"opt": want.opt._asdict()})
    gf = _flat(got._asdict() | {"opt": got.opt._asdict()})
    assert {p: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for p, v in gf.items()} == \
        {p: (tuple(v.shape), str(v.dtype)) for p, v in wf.items()}
    assert all(v.device.type == "meta" for v in gf.values())
    assert got_axes.params == want_axes.params
    assert got_axes.opt.step == want_axes.opt.step == ""


def test_kernel_wrappers_refuse_operands_that_require_grad():
    """Each ctypes-launching wrapper raises for an operand that requires
    grad while grad mode is on, before it looks at the device (these are
    CPU tensors); under no_grad it gets to its device check."""
    from repro_torch.kernels.decode_attention.kernel import \
        decode_attention_kernel
    from repro_torch.kernels.flash_attention.kernel import \
        flash_attention_kernel
    from repro_torch.kernels.sketch_update import kernel as K

    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    kv = torch.randn(1, 4, 2, 8)
    with pytest.raises(RuntimeError, match="requires grad"):
        flash_attention_kernel(q, kv, kv)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_kernel(q, kv, kv)
    qd = torch.randn(1, 2, 2, 8)
    cache = torch.randn(1, 4, 2, 8, requires_grad=True)
    valid = torch.ones(1, 4, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="requires grad"):
        decode_attention_kernel(qd, cache, cache, valid)
    # the sketch kernels' operands are int32 and cannot require grad; the
    # unbiased kernel's uniforms are f32
    z = torch.zeros(2, 4, dtype=torch.int32)
    one = torch.zeros(2, dtype=torch.int32)
    u = torch.rand(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="requires grad"):
        K.sketch_unbiased_kernel(z, z, z, z, z, z, one[:0].new_zeros(3),
                                 one[:0].new_zeros(3), u,
                                 one[:0].new_zeros(3),
                                 torch.zeros(5, dtype=torch.int32))


def test_attend_on_cpu_takes_the_plain_path_under_grad():
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import layers as L

    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 4, 16)).astype(
        np.float32)).requires_grad_(True) for _ in range(3))
    out = L._attend(q, k[:, :, :2], v[:, :, :2], True, 0, "kernel")
    want = flash_attention_ref(q, k[:, :, :2], v[:, :, :2], causal=True)
    assert torch.equal(out, want)
    (gq,) = torch.autograd.grad(out.sum(), [q])
    (wq,) = torch.autograd.grad(want.sum(), [q])
    assert torch.equal(gq, wq)
