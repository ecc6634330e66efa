"""The expert-FFN kernels at a width off their instances: ``pad_call``.

The kernels (K3, K4, K8, K9, K10) are compiled for D in ``KERNEL_DIMS``
(192, 384, 768) and H a multiple of 64; the JAX kernel takes any D and any
even H. ``fused_ffn.pad_call`` zero-pads D up to the next instance and H to
the next multiple of 64, runs the kernel and slices the outputs back. Here
on the CPU it runs each form's plain version (what the card compares its
kernel with) at D = 256, H = 1000, pads and all:

- against the same plain version unpadded, bit for bit in f32 (the pads
  add exact zeros to every sum, and GELU(0) = 0);
- against the JAX package's ``fused_expert_ffn`` forward and ``jax.vjp``
  (its Pallas kernels in interpret mode, as its own tests run them on the
  CPU), within the port's f32 parity limit 1e-5 of max |want| (the same
  f32 math in other summation orders, ``tests/test_torch_backward.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.ops import fused_ffn as jax_ffn
from slim_switch_moe_vit_tpu.ops import moe as jax_moe
from slim_switch_moe_vit_tpu_torch.ops import fused_ffn as torch_ffn

D, H, E, T = 256, 1000, 4, 150  # MoEMlp(256, 1000): D 256 -> 384, H -> 1024
F32_PARITY = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread while this module runs (several pytest
    workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed=0):
    """Numpy arrays of a routed layout (expert E-1 starved: one all-padding
    tile) at D x H: xs, dy (zero at padding slots), w1, b1, w2, b2,
    e_of_tile, and the tokens x with their gather index."""
    rs = np.random.RandomState(seed)
    eidx = rs.randint(0, E - 1, (T, 2)).astype(np.int32)
    gather_idx, _, e_of_tile, w_slot, _ = jax_moe.aligned_expert_layout(
        jnp.asarray(eidx), E, gate_w=jnp.ones((T, 2)),
        weight_dtype=jnp.float32)
    gidx = np.asarray(gather_idx)
    real = np.asarray(w_slot) > 0
    x = rs.randn(T, D).astype(np.float32)
    xs = x[gidx]
    dy = (rs.randn(len(xs), D) * real[:, None]).astype(np.float32)
    w1 = (rs.randn(E, D, H) * D ** -0.5).astype(np.float32)
    b1 = (rs.randn(E, H) * 0.1).astype(np.float32)
    w2 = (rs.randn(E, H, D) * H ** -0.5).astype(np.float32)
    b2 = (rs.randn(E, D) * 0.1).astype(np.float32)
    return xs, dy, w1, b1, w2, b2, np.asarray(e_of_tile), x, gidx


def _t(a):
    return torch.from_numpy(np.array(a))


def test_kernel_dims():
    """The instance each shape runs at; D past 768 raises, naming the
    cap."""
    kd = torch_ffn.kernel_dims
    assert kd(256, 1000) == (384, 1024)
    assert kd(384, 1536) == (384, 1536) and kd(768, 3072) == (768, 3072)
    assert kd(1, 2) == (192, 64) and kd(193, 65) == (384, 128)
    with pytest.raises(ValueError, match="D <= 768"):
        kd(1024, 4096)


def test_registered_shapes_take_no_copy():
    """At an instance's shape pad_call hands the kernel the caller's own
    tensors and returns its outputs as they are."""
    xs, w1, b1 = torch.zeros(256, 384), torch.zeros(2, 384, 128), \
        torch.zeros(2, 128)
    w2, b2 = torch.zeros(2, 128, 384), torch.zeros(2, 384)
    seen = []

    def fn(*args):
        seen.extend(args)
        return xs

    assert torch_ffn.pad_call(fn, xs, w1, b1, w2, b2) is xs
    assert all(a is b for a, b in zip(seen, (xs, w1, b1, w2, b2, None)))


def _forms(xs, dy, w1, b1, w2, b2, eot, x, gidx):
    """{form: (padded call, unpadded call)} over each kernel form's plain
    version."""
    ff = torch_ffn
    n_tiles = eot.shape[0]
    perm = torch.arange(n_tiles, dtype=torch.int32).flip(0)

    def pair(plain, fwd):
        if fwd:
            padded = ff.pad_call(lambda x_, a, b, c, d, _: plain(x_, a, b, c, d),
                                 xs, w1, b1, w2, b2)
            return padded, plain(xs, w1, b1, w2, b2)
        padded = ff.pad_call(lambda x_, a, b, c, _, g: plain(x_, a, b, c, g),
                             xs, w1, b1, w2, dy=dy)
        return padded, plain(xs, w1, b1, w2, dy)

    xg = x.index_select(0, gidx)
    return {
        "fwd (K3)": pair(lambda *a: ff.fused_expert_ffn_reference(*a, eot),
                         True),
        "bwd (K4)": pair(lambda *a: ff.reference_expert_ffn_bwd(
            *a[:4], eot, a[4]), False),
        "defer (K8)": pair(lambda *a: ff.reference_expert_ffn_bwd_defer(
            *a[:4], eot, a[4]), False),
        "gather fwd (K9)": (
            ff.pad_call(lambda x_, a, b, c, d, _: ff.fused_expert_ffn_reference(
                x_.index_select(0, gidx), a, b, c, d, eot), x, w1, b1, w2, b2),
            ff.fused_expert_ffn_reference(xg, w1, b1, w2, b2, eot)),
        "gather bwd (K9)": (
            ff.pad_call(lambda x_, a, b, c, _, g: ff.reference_expert_ffn_bwd(
                x_.index_select(0, gidx), a, b, c, eot, g), x, w1, b1, w2,
                dy=dy),
            ff.reference_expert_ffn_bwd(xg, w1, b1, w2, eot, dy)),
        "permuted fwd (K10)": pair(lambda *a: ff.reference_expert_ffn_permuted(
            *a, eot, perm), True),
        "permuted bwd (K10)": pair(
            lambda *a: ff.reference_expert_ffn_bwd_permuted(
                *a[:4], eot, perm, a[4]), False),
    }


FORMS = ["fwd (K3)", "bwd (K4)", "defer (K8)", "gather fwd (K9)",
         "gather bwd (K9)", "permuted fwd (K10)", "permuted bwd (K10)"]


@pytest.fixture(scope="module")
def forms():
    xs, dy, w1, b1, w2, b2, eot, x, gidx = _case()
    return _forms(_t(xs), _t(dy), _t(w1), _t(b1), _t(w2), _t(b2), _t(eot),
                  _t(x), _t(gidx).long())


@pytest.mark.parametrize("form", FORMS)
def test_padded_plain_path_is_bit_exact(forms, form):
    """Each form's plain version through pad_call at D = 256, H = 1000
    equals it unpadded bit for bit, outputs of the caller's shapes."""
    padded, plain = forms[form]
    padded = padded if isinstance(padded, tuple) else (padded,)
    plain = plain if isinstance(plain, tuple) else (plain,)
    for i, (a, b) in enumerate(zip(padded, plain, strict=True)):
        assert a.shape == b.shape and a.dtype == b.dtype, (form, i)
        assert torch.equal(a, b), (form, i, (a - b).abs().max().item())


def test_padded_path_matches_jax(forms):
    """The padded plain forward and backward (what K3 and K4 are held to on
    the card) against the JAX package's fused_expert_ffn and its VJP at
    D = 256, H = 1000: y, dx, dW1, db1, dW2, db2 within 1e-5 of max
    |want|."""
    xs, dy, w1, b1, w2, b2, eot, _, _ = _case()
    y, vjp = jax.vjp(lambda *a: jax_ffn.fused_expert_ffn(
        *a, jnp.asarray(eot)), *(jnp.asarray(a) for a in (xs, w1, b1, w2, b2)))
    want = [y, *vjp(jnp.asarray(dy))]
    got = [forms["fwd (K3)"][0], *forms["bwd (K4)"][0]]
    for name, g, w in zip(["y", "dx", "dw1", "db1", "dw2", "db2"], got, want,
                          strict=True):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=F32_PARITY * np.abs(w).max(),
                                   err_msg=name)


def test_deferred_form_pads_h_to_d():
    """K8 needs H >= D: at D = 256, H = 300, which pad_call alone would run
    at 384 x 320, ``h_at_least_d`` runs K8's plain version at 384 x 384,
    bit for bit equal to it unpadded."""
    assert torch_ffn.kernel_dims(256, 300) == (384, 320)
    assert torch_ffn.kernel_dims(256, 300, h_at_least_d=True) == (384, 384)
    assert torch_ffn.kernel_dims(384, 1536, h_at_least_d=True) == (384, 1536)
    rs = np.random.RandomState(3)
    eot = _t(np.array([0, 1, 1], np.int32))
    xs, dy = _t(rs.randn(3 * 256, 256)), _t(rs.randn(3 * 256, 256))
    w1, b1 = _t(rs.randn(2, 256, 300) / 16), _t(rs.randn(2, 300) / 10)
    w2 = _t(rs.randn(2, 300, 256) / 17)
    xs, dy, w1, b1, w2 = (t.float() for t in (xs, dy, w1, b1, w2))
    seen = []

    def defer(x_, a, b, c, _, g):
        seen.append(tuple(a.shape))
        return torch_ffn.reference_expert_ffn_bwd_defer(x_, a, b, c, eot, g)

    got = torch_ffn.pad_call(defer, xs, w1, b1, w2, dy=dy, h_at_least_d=True)
    want = torch_ffn.reference_expert_ffn_bwd_defer(xs, w1, b1, w2, eot, dy)
    assert seen == [(2, 384, 384)]
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        assert a.shape == b.shape and torch.equal(a, b), i
