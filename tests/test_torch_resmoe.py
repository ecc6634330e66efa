"""The port's gated ResMoE ViT vs the JAX package's.

A small model (img 32, patch 8 -> N=17, D=64, 2 ResMoE blocks, 2 heads, 4
experts top-2) is initialized in JAX; its weights (the gate heads scaled
by 8 so the gate probabilities spread around 0.5) and its ``gates``
collection are carried across with ``from_jax_params``. Block 0's norm1 is
the plain LN, every later norm the slim LN, as on the card. The JAX side
runs its plain paths (XLA LN and attention, ragged dispatch), as its own
tests do on the CPU: the Pallas kernels behind them are held to the port
kernel by kernel in tests/test_torch_fused_ln.py, test_torch_attention.py
and test_torch_moe.py, and interpreting them here would take this file
past its time budget. The train-step test runs the JAX step's fused
optimizer, K7, interpreted.

Forward (logits, skip_fraction, balance_loss) and gradients of a training
forward, and the eval logits:

- f32, gates enabled at threshold 0.5, so ~45% of the tokens are skipped
  (training and eval thresholds both 0.5; every gate probability is at
  least 1e-4 from it, checked, so no hard decision can flip between the
  two packages' f32 sums): parity mode, and compact mode at capacity 1.0,
  where every token is gathered, so the order of the gathered tokens (a
  sort of keep weights that are 1 +- an ulp, which depend on each
  package's f32 rounding) cannot change the result. Logits within 1e-4
  (2.5e-7 of max measured); gradients within 1e-4 of each leaf's largest
  |ref| (2.2e-6 measured). A gate head's gradient is a sum over tokens of
  terms that nearly cancel (block 0's dense-gate bias is 3.4e-8 against
  kernel entries of 1.6e-4), so its kernel and bias are held within 1e-3
  of the head's largest |ref| (1.4e-4 measured).
- bf16: parity mode with the gates enabled at threshold 1.0 (the STE path
  runs but no token is hard-skipped: a bf16 probability near a threshold
  could flip), and compact mode at capacity 0.5 with the gates disabled
  (every keep weight exactly 1, so the stable sort picks the first
  ceil(17*0.5) -> 16 tokens on both sides). Logits within 5e-2 of the
  largest |logit| (0.51% measured), gradients within 0.15 of each leaf's
  largest |ref| (0.07 measured, on block 0's qkv bias: bf16 roundings land
  in other places). The gate heads' bf16 gradients are not compared: their
  near-cancelling sums are below bf16's rounding of the terms (the port's
  and JAX's block-0 dense-gate bias gradients differ by 72x their value).

The compact gather itself is held to JAX exactly, on the same keep weights
with ties, and two train steps with ``use_fused_optimizer`` (the JAX
step's K7 runs interpreted) land where the JAX package's do.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu import losses as jax_losses
from slim_switch_moe_vit_tpu import optim as jax_optim
from slim_switch_moe_vit_tpu.engine import make_train_step as jax_make_step
from slim_switch_moe_vit_tpu.models.resmoe import ResMoEBlock as JaxResMoEBlock
from slim_switch_moe_vit_tpu.models.vit import \
    VisionTransformer as JaxVisionTransformer
from slim_switch_moe_vit_tpu.train_state import TrainState as JaxTrainState
from slim_switch_moe_vit_tpu_torch import engine, losses, optim
from slim_switch_moe_vit_tpu_torch.models import gates as port_gates
from slim_switch_moe_vit_tpu_torch.models.resmoe import ResMoEBlock
from slim_switch_moe_vit_tpu_torch.models.vit import VisionTransformer
from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import (
    from_jax_params,
    to_jax_tree,
)

CFG = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64, depth=2,
           num_heads=2)
B = 4
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(dtype, mode, capacity):
    def block(idx, **bk):
        return JaxResMoEBlock(num_experts=4, top_k=2, dispatch_mode="ragged",
                              mode=mode, token_capacity=capacity, **bk)
    return JaxVisionTransformer(ln_impl="xla", attn_impl="xla",
                                dtype=jnp.dtype(dtype), block_factory=block,
                                **CFG)


def _torch_model(dtype, mode, capacity):
    def block(idx, **bk):
        return ResMoEBlock(num_experts=4, top_k=2, mode=mode,
                           token_capacity=capacity, **bk)
    return VisionTransformer(dtype=getattr(torch, dtype), block_factory=block,
                             **CFG)


def _data(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, 32, 32, 3).astype(np.float32),
            rs.randint(0, 10, B))


@pytest.fixture(scope="module")
def jax_vars():
    m = _jax_model("float32", "parity", 1.0)
    v = jax.jit(lambda x: m.init({"params": jax.random.PRNGKey(0)}, x,
                                 deterministic=True))(jnp.zeros((1, 32, 32, 3)))
    # gate heads scaled up so the probabilities spread around 0.5
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 8.0 if "gate" in jax.tree_util.keystr(p) else a,
        v["params"])
    return params, v["gates"]


def _gates(tree, threshold, enabled):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(
            {"threshold": threshold, "target_threshold": threshold,
             "enabled": enabled}[p[-1].key], jnp.float32), tree)


def _jax_run(params, gates, dtype, mode, capacity, x, y, evaluate):
    jm = _jax_model(dtype, mode, capacity)
    crit = jax_losses.make_base_criterion(False, 0.1, False)

    def loss_fn(p, x):
        out, mut = jm.apply({"params": p, "gates": gates}, x,
                            deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(0)},
                            mutable=["moe_metrics"])
        mm = mut["moe_metrics"]
        return crit(out, y), (out, mm)

    xj = jnp.asarray(x, jnp.dtype(dtype))
    (_, (logits, mm)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, xj)
    ev = jax.jit(lambda p, x: jm.apply({"params": p, "gates": gates}, x,
                                       deterministic=True))(
        params, xj) if evaluate else None
    leaves = jax.tree_util.tree_leaves_with_path(mm)
    metrics = {k: float(np.mean([np.asarray(v) for p, v in leaves
                                 if p[-1].key == k]))
               for k in ("skip_fraction", "balance_loss")}
    return np.asarray(logits), ev, grads, metrics


def _torch_run(params, gates, dtype, mode, capacity, x, y):
    m = _torch_model(dtype, mode, capacity)
    m.load_state_dict(from_jax_params(params, gates))
    probs = []
    hooks = [g.head.register_forward_hook(
        lambda mod, i, o: probs.append(torch.sigmoid(o.detach())))
        for g in port_gates.gate_modules(m).values()]
    crit = losses.make_base_criterion(False, 0.1, False)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    m.train()
    logits = m(xt)
    crit(logits, torch.from_numpy(y)).backward()
    metrics = engine._collect_moe_metrics(engine._moe_modules(m))
    with torch.no_grad():
        ev = m.eval()(xt)
    for h in hooks:
        h.remove()
    grads = to_jax_tree({n: p.grad for n, p in m.named_parameters()})
    return (logits.detach().numpy(), ev.numpy(), grads,
            {k: float(v) for k, v in metrics.items()}, probs)


def _is_gate(path):
    return "gate" in jax.tree_util.keystr(path)


def _leaf_close(got_tree, want_tree, rel, gate_rel):
    """Each leaf within ``rel`` of its largest |ref|; a gate head's kernel
    and bias within ``gate_rel`` of the head's largest |ref| (None: not
    compared)."""
    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    assert got.keys() == want.keys()
    head_max = {}
    for path, w in want.items():
        if _is_gate(path):
            head = jax.tree_util.keystr(path[:-1])
            head_max[head] = max(head_max.get(head, 0.0), np.abs(w).max())
    for path, w in want.items():
        w = np.asarray(w, np.float32)
        if _is_gate(path):
            if gate_rel is None:
                continue
            atol = gate_rel * head_max[jax.tree_util.keystr(path[:-1])]
        else:
            atol = rel * np.abs(w).max()
        np.testing.assert_allclose(got[path], w, rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize(
    "dtype,mode,capacity,threshold,enabled,evaluate", [
        ("float32", "parity", 1.0, 0.5, 1.0, True),
        ("float32", "compact", 1.0, 0.5, 1.0, False),
        ("bfloat16", "parity", 1.0, 1.0, 1.0, False),
        ("bfloat16", "compact", 0.5, 0.5, 0.0, True)])
def test_resmoe_forward_and_grads_match_jax(jax_vars, dtype, mode, capacity,
                                            threshold, enabled, evaluate):
    """The training forward and its gradients; with ``evaluate``, also the
    eval forward (the target threshold, no gradients)."""
    params, gates = jax_vars
    gates = _gates(gates, threshold, enabled)
    x, y = _data()
    want, want_ev, want_g, want_m = _jax_run(params, gates, dtype, mode,
                                             capacity, x, y, evaluate)
    got, got_ev, got_g, got_m, probs = _torch_run(params, gates, dtype, mode,
                                                  capacity, x, y)
    f32 = dtype == "float32"
    if f32 and enabled:  # every hard decision far from the line
        p = torch.cat([q.flatten() for q in probs])
        assert (p - threshold).abs().min() > MARGIN
        assert 0.2 < got_m["skip_fraction"] < 0.8
    tol = 1e-4 if f32 else 5e-2 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if evaluate:
        np.testing.assert_allclose(got_ev, np.asarray(want_ev), rtol=0,
                                   atol=tol)
    for k, v in want_m.items():
        np.testing.assert_allclose(got_m[k], v, rtol=1e-5 if f32 else 2e-2,
                                   atol=1e-6, err_msg=k)
    _leaf_close(got_g, want_g, *((1e-4, 1e-3) if f32 else (0.15, None)))
    gate_g = np.abs(got_g["blocks_0"]["dense_gate"]["head"]["kernel"]).max()
    assert gate_g > 0 if enabled else gate_g == 0


@pytest.mark.parametrize("capacity", [0.25, 0.5, 0.9])
def test_compact_selection_matches_jax_exactly(capacity):
    """``_compact_apply`` on the same keep weights (values 0, 1 and 1 +- an
    ulp, with ties): the same selection in the same order, scattered back
    to the same places, and the tokens past capacity zeroed."""
    rs = np.random.RandomState(7)
    Bc, N, d = 3, 37, 5
    x = rs.randn(Bc, N, d).astype(np.float32)
    one = np.float32(1.0)
    choices = np.array([0.0, one, np.nextafter(one, 2), np.nextafter(one, 0),
                        1e-8], np.float32)
    keep = choices[rs.randint(0, len(choices), (Bc, N, 1))]

    def tagged(ns):  # a function of the token and of its place in the short sequence
        def fn(t):
            C = t.shape[1]
            return t * 2.0 + ns.arange(C, dtype=t.dtype)[None, :, None]
        return fn

    want = JaxResMoEBlock._compact_apply(
        types.SimpleNamespace(token_capacity=capacity), tagged(jnp),
        jnp.asarray(x), jnp.asarray(keep), True)
    got = ResMoEBlock._compact_apply(
        types.SimpleNamespace(token_capacity=capacity), tagged(torch),
        torch.from_numpy(x), torch.from_numpy(keep))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    C = min((int(np.ceil(N * capacity)) + 7) // 8 * 8, N)
    assert ((got.numpy() != 0).any(-1).sum(1) <= C).all()


def test_fused_optimizer_train_steps_match_jax(jax_vars):
    """Two f32 steps, parity mode, gates enabled at 0.5, AdamW (wd 0.05,
    the timm mask, the gate lr on the gate heads) + EMA through the fused
    optimizer on both sides. Losses within 1e-4; the moves of params and
    EMA from the shared start within 5e-2 of each leaf's largest JAX move
    (tests/test_torch_train.py's measure: Adam turns rounding-size gradient
    differences into moves of up to lr)."""
    params, gates = jax_vars
    gates = _gates(gates, 0.5, 1.0)
    lr, lr_gate, decay, steps = 1e-3, 3e-3, 0.9, 2
    batches = [_data(10 + i) for i in range(steps)]

    jm = _jax_model("float32", "parity", 1.0)
    crit = jax_losses.make_base_criterion(False, 0.1, False)
    opt_init, opt_update = jax_optim.make_optimizer(params, weight_decay=0.05)
    assert hasattr(opt_update, "fused_apply")
    state = JaxTrainState(params=params, opt_state=opt_init(params),
                          gates=gates,
                          ema_params=jax.tree.map(jnp.copy, params),
                          rng=jax.random.PRNGKey(1),
                          step=jnp.asarray(0, jnp.int32))
    step = jax_make_step(jm, opt_update, crit, ema_decay=decay, donate=False,
                         use_fused_optimizer=True)
    want = []
    for x, y in batches:
        state, m = step(state, jnp.asarray(x), jnp.asarray(y),
                        jnp.float32(lr), jnp.float32(lr_gate))
        want.append({k: float(v) for k, v in m.items()})

    model = _torch_model("float32", "parity", 1.0)
    model.load_state_dict(from_jax_params(params, gates))
    p_init, p_update = optim.make_optimizer(weight_decay=0.05)
    tstate = create_train_state(model, device="cpu", opt_init=p_init,
                                use_ema=True)
    tstep = engine.make_train_step(
        model, p_update, losses.make_base_criterion(False, 0.1, False),
        ema_decay=decay, use_fused_optimizer=True)
    got = []
    for x, y in batches:
        tstate, m = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y),
                          lr, lr_gate)
        got.append({k: float(v) for k, v in m.items()})

    for g, w in zip(got, want):
        assert g.keys() == w.keys() == {"loss", "balance_loss",
                                        "drop_fraction", "skip_fraction"}
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    assert all(float(tstate.optimizer.state[p]["step"]) == steps
               for p in model.parameters())
    for what, got_tree, want_tree in (
            ("param", to_jax_tree(dict(model.named_parameters())),
             state.params),
            ("ema", to_jax_tree(tstate.ema_params), state.ema_params)):
        g = dict(jax.tree_util.tree_leaves_with_path(got_tree))
        for path, w in jax.tree_util.tree_leaves_with_path(want_tree):
            b = np.asarray(dict(jax.tree_util.tree_leaves_with_path(
                params))[path], np.float64)
            wm = np.asarray(w, np.float64) - b
            np.testing.assert_allclose(
                np.asarray(g[path], np.float64) - b, wm, rtol=0,
                atol=5e-2 * np.abs(wm).max(),
                err_msg=f"{what} {jax.tree_util.keystr(path)}")
    # the gate buffers ride in the model, untouched by the steps
    assert all(float(gm.threshold) == np.float32(0.5)
               for gm in port_gates.gate_modules(model).values())
