"""The PyTorch port's training step vs the JAX package's, end to end.

The small model of tests/test_torch_vit.py (img 32, patch 8 -> N=17, D=64,
2 blocks, 2 heads, 4 experts top-2) is initialized in JAX with its Pallas
kernels forced on (interpret mode on the CPU), its weights carried across
with ``from_jax_params``, and the same seeded batches go through both
packages' ``make_train_step`` (label smoothing 0.1, AdamW wd 0.05 with the
timm no-decay mask, EMA) for 3 steps.

Tolerances:
- f32: losses rtol 1e-4; step-1 gradients within 1e-5 of each leaf's
  largest |ref| (both sides do the same f32 math in different summation
  orders: 7e-7 measured). Params and EMA are judged by their moves over the
  3 steps (from the shared initial weights), each within 5e-2 of the
  leaf's largest JAX move: 1.6e-2 measured on params, 2.5e-2 on the EMA
  (Adam divides each gradient element by its own running rms, so an
  element whose gradient is at rounding-noise size moves by up to +-lr on
  that noise). The EMA moves ~0.06 lr at decay 0.99, so one that never
  updates, or decays at 0.999, is off by 100% or 90% of its move.
- bf16: losses rtol 2e-2; step-1 gradients within 0.1 of each leaf's
  largest |ref| (bf16 roundings land in other places, and the JAX
  package's bf16 GELU / GELU' are polynomials within 5.7e-4 / 1.5e-3 of
  the exact forms the port uses: 0.079 measured on the noise-only key
  bias, 0.034 at most elsewhere). Each leaf's move, params and EMA, at
  cosine >= 0.6 to the JAX move (0.71 measured on the qkv bias, whose key
  third has a gradient that is zero but for rounding, since softmax
  ignores a shift shared by a row's scores; >= 0.98 elsewhere) and with
  a norm within 10% of it (0.953-1.024 measured).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu import losses as jax_losses
from slim_switch_moe_vit_tpu import optim as jax_optim
from slim_switch_moe_vit_tpu.engine import \
    _collect_moe_metrics as jax_collect_moe_metrics
from slim_switch_moe_vit_tpu.engine import make_train_step as jax_make_step
from slim_switch_moe_vit_tpu.models.moe import MoEMlp as JaxMoEMlp
from slim_switch_moe_vit_tpu.models.vit import \
    VisionTransformer as JaxVisionTransformer
from slim_switch_moe_vit_tpu.train_state import TrainState as JaxTrainState
from slim_switch_moe_vit_tpu_torch import engine, losses, optim
from slim_switch_moe_vit_tpu_torch.models.moe import MoEMlp
from slim_switch_moe_vit_tpu_torch.models.vit import VisionTransformer
from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import (
    from_jax_params,
    to_jax_tree,
)

CFG = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64, depth=2,
           num_heads=2)
LR, EMA, STEPS, B = 1e-3, 0.99, 3, 4
MOVE_REL, MOVE_COS_BF16, MOVE_NORM_BF16 = 5e-2, 0.6, 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread while this module runs: the suite runs
    several pytest workers per host, and torch's oversubscribed thread pool
    made these tests ~100x slower there than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(dtype):
    def factory(idx, dim, ratio, drop, dt):
        return JaxMoEMlp(num_experts=4, top_k=2,
                         hidden_features=int(dim * ratio), dtype=dt,
                         dispatch_mode="fused", name="mlp")
    return JaxVisionTransformer(ln_impl="fused", attn_impl="fused",
                                dtype=jnp.dtype(dtype),
                                block_mlp_factory=factory, **CFG)


def _torch_model(dtype):
    def factory(idx, dim, ratio, drop, dt):
        return MoEMlp(dim, int(dim * ratio), num_experts=4, top_k=2)
    return VisionTransformer(dtype=getattr(torch, dtype),
                             block_mlp_factory=factory, **CFG)


def _batches():
    return [(np.random.RandomState(10 + i).randn(B, 32, 32, 3).astype(
        np.float32), np.random.RandomState(20 + i).randint(0, 10, B))
        for i in range(STEPS)]


@pytest.fixture(scope="module")
def jax_params():
    m = _jax_model("float32")
    return jax.jit(lambda x: m.init({"params": jax.random.PRNGKey(0)}, x,
                                    deterministic=True))(
        jnp.zeros((1, 32, 32, 3)))["params"]


def _leaf_close(got_tree, want_tree, what, rel):
    """Every leaf within ``rel`` x its largest |ref|."""
    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    assert got.keys() == want.keys()
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            got[path], w, rtol=0, atol=rel * np.abs(w).max(),
            err_msg=f"{what} {jax.tree_util.keystr(path)}")


def _moves_match(got_tree, want_tree, base_tree, what, f32):
    """Each leaf's move from ``base_tree`` against the JAX move: in f32
    within MOVE_REL of its largest |ref move| elementwise; in bf16 at
    cosine >= MOVE_COS_BF16 with a norm within MOVE_NORM_BF16 of it."""
    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    base = dict(jax.tree_util.tree_leaves_with_path(base_tree))
    assert got.keys() == want.keys() == base.keys()
    for path, w in want.items():
        b = np.asarray(base[path], np.float64)
        gm = np.asarray(got[path], np.float64) - b
        wm = np.asarray(w, np.float64) - b
        msg = f"{what} move {jax.tree_util.keystr(path)}"
        if f32:
            np.testing.assert_allclose(gm, wm, rtol=0,
                                       atol=MOVE_REL * np.abs(wm).max(),
                                       err_msg=msg)
            continue
        gn, wn = np.linalg.norm(gm), np.linalg.norm(wm)
        assert abs(gn / wn - 1) <= MOVE_NORM_BF16, (msg, gn / wn)
        assert (gm * wm).sum() / (gn * wn) >= MOVE_COS_BF16, msg


def _run_jax(params, dtype, balance_weight):
    jm = _jax_model(dtype)
    crit = jax_losses.make_base_criterion(False, 0.1, False)
    opt_init, opt_update = jax_optim.make_optimizer(params, weight_decay=0.05)
    state = JaxTrainState(
        params=params, opt_state=opt_init(params), gates={},
        ema_params=jax.tree.map(jnp.copy, params),
        rng=jax.random.PRNGKey(1), step=jnp.asarray(0, jnp.int32))
    step = jax_make_step(jm, opt_update, crit, ema_decay=EMA,
                         moe_balance_weight=balance_weight, donate=False)

    def loss_fn(p, x, y):
        out, mut = jm.apply({"params": p}, x, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(0)},
                            mutable=["moe_metrics"])
        mm = jax_collect_moe_metrics(mut)
        return crit(out, y) + balance_weight * mm["balance_loss"]

    batches = _batches()
    grads = jax.jit(jax.grad(loss_fn))(params, jnp.asarray(batches[0][0]),
                                       jnp.asarray(batches[0][1]))
    metrics = []
    for x, y in batches:
        state, m = step(state, jnp.asarray(x), jnp.asarray(y),
                        jnp.float32(LR), jnp.float32(LR))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, grads, state


def _run_torch(params, dtype, balance_weight):
    model = _torch_model(dtype)
    model.load_state_dict(from_jax_params(params))
    opt_init, opt_update = optim.make_optimizer(weight_decay=0.05)
    state = create_train_state(model, device="cpu", opt_init=opt_init,
                               use_ema=True)
    step = engine.make_train_step(
        model, opt_update, losses.make_base_criterion(False, 0.1, False),
        ema_decay=EMA, moe_balance_weight=balance_weight)
    metrics, grads = [], None
    for x, y in _batches():
        state, m = step(state, torch.from_numpy(x), torch.from_numpy(y), LR,
                        LR)
        metrics.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = to_jax_tree({n: p.grad for n, p in
                                 model.named_parameters()})
    return metrics, grads, state


@pytest.mark.parametrize("dtype,balance_weight", [
    ("float32", 0.0), ("float32", 0.01), ("bfloat16", 0.0),
    ("bfloat16", 0.01)])
def test_train_steps_match_jax(jax_params, dtype, balance_weight):
    want, want_grads, jstate = _run_jax(jax_params, dtype, balance_weight)
    got, got_grads, tstate = _run_torch(jax_params, dtype, balance_weight)
    f32 = dtype == "float32"
    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"loss", "balance_loss",
                                        "drop_fraction"}
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4 if f32 else 2e-2,
                                       atol=1e-6, err_msg=k)
    _leaf_close(got_grads, want_grads, "grad", rel=1e-5 if f32 else 0.1)
    _moves_match(to_jax_tree(dict(tstate.model.named_parameters())),
                 jstate.params, jax_params, "param", f32)
    _moves_match(to_jax_tree(tstate.ema_params), jstate.ema_params,
                 jax_params, "ema", f32)
    assert tstate.step == STEPS


def test_train_one_epoch_averages_the_window(jax_params, capsys):
    """train_one_epoch over a list of batches: the averaged loss and
    balance_loss are the means of the steps' own metrics."""
    model = _torch_model("float32")
    model.load_state_dict(from_jax_params(jax_params))
    opt_init, opt_update = optim.make_optimizer(weight_decay=0.05)
    crit = losses.make_base_criterion(False, 0.1, False)

    def fresh():
        model.load_state_dict(from_jax_params(jax_params))
        return create_train_state(model, device="cpu", opt_init=opt_init,
                                  use_ema=True)

    step = engine.make_train_step(model, opt_update, crit, ema_decay=EMA)
    data = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in _batches()]
    state, each = fresh(), []
    for x, y in data:
        state, m = step(state, x, y, LR, LR)
        each.append(m)
    state, stats = engine.train_one_epoch(fresh(), step, data, 0, LR, LR,
                                          print_freq=2)
    assert state.step == STEPS
    for k in ("loss", "balance_loss", "drop_fraction"):
        np.testing.assert_allclose(stats[k], np.mean([float(m[k])
                                                      for m in each]),
                                   rtol=1e-6, err_msg=k)
    assert stats["lr"] == LR and "Averaged stats" in capsys.readouterr().out


def test_train_state_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(_torch_model("float32"))


def test_eval_step_and_evaluate(jax_params):
    model = _torch_model("float32")
    model.load_state_dict(from_jax_params(jax_params))
    state = create_train_state(model, device="cpu", use_ema=True)
    data = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in _batches()]
    ev = engine.make_eval_step(model)
    ev_ema = engine.make_eval_step(model, use_ema=True)
    for x, y in data:  # the EMA copy equals the params before any step
        for a, b in zip(ev(state, x, y), ev_ema(state, x, y)):
            torch.testing.assert_close(a, b)
    with torch.no_grad():
        logits = model.eval()(data[0][0])
    loss, acc1, acc5 = ev(state, *data[0])
    torch.testing.assert_close(loss, losses.cross_entropy(logits, data[0][1]))
    stats = engine.evaluate(state, ev, data, print_freq=2)
    assert set(stats) == {"loss", "acc1", "acc5"}
    assert 0.0 <= stats["acc1"] <= stats["acc5"] <= 100.0


def test_train_one_epoch_aborts_on_a_nan_loss(capsys):
    """The windowed fetch still stops the run on a non-finite loss."""
    def step(state, x, y, lr_base, lr_gate):
        return state, {"loss": torch.tensor(float("nan"))}

    data = [(torch.zeros(1), torch.zeros(1))] * 3
    with pytest.raises(SystemExit):
        engine.train_one_epoch(None, step, data, 0, LR, LR, print_freq=2)
    assert "Loss is nan" in capsys.readouterr().out
