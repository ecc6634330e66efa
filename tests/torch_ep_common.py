"""Shared pieces of the expert-parallel parity tests
(``tests/test_torch_ep*.py``): the inputs, the port's run on gloo ranks of
this host (``parallel/launch.py``; the children import the port only) and
the JAX package's shard-map forms on the conftest's 8 virtual devices."""
import jax
import jax.numpy as jnp
import numpy as np

from slim_switch_moe_vit_tpu.ops import moe as jax_moe
from slim_switch_moe_vit_tpu.parallel import make_mesh
from slim_switch_moe_vit_tpu.parallel.sharding import EXPERT_AXIS, constrain
from slim_switch_moe_vit_tpu_torch.parallel import launch

E, D, H, K = 8, 16, 32, 2  # as tests/test_ep_a2a.py:22
PARAMS = ("router_w", "router_b", "w1", "b1", "w2", "b2")
TOL = 2e-5  # f32, as the JAX package's EP tests
# the loss differentiated on both sides: sum(y * c) + BALANCE_WEIGHT *
# balance_loss; at 0.5 the balance term moves the router and x gradients
# by more than 10 x TOL (tests/test_torch_ep.py checks it), so a wrong
# scale of its cotangent under EP shows
BALANCE_WEIGHT = 0.5


def inputs(T: int, seed: int) -> dict:
    """Weights scaled as tests/test_ep_a2a.py's, tokens and the loss's
    cotangent weights, from one numpy seed."""
    rs = np.random.RandomState(seed)
    return dict(
        router_w=(rs.randn(D, E) * 0.5).astype(np.float32),
        router_b=(rs.randn(E) * 0.1).astype(np.float32),
        w1=(rs.randn(E, D, H) * 0.1).astype(np.float32),
        b1=(rs.randn(E, H) * 0.1).astype(np.float32),
        w2=(rs.randn(E, H, D) * 0.1).astype(np.float32),
        b2=(rs.randn(E, D) * 0.1).astype(np.float32),
        x=rs.randn(T, D).astype(np.float32),
        c=rs.randn(T, D).astype(np.float32),
        balance_weight=np.float32(BALANCE_WEIGHT))


def run_port(tmp_path, dp: int, ep: int, data: dict, runs) -> dict:
    """The port's forms on dp x ep gloo ranks: {run key: {y, dx, aux values,
    gradients of sum(y * c) + balance_weight * balance_loss}} assembled
    over the ranks, each the whole batch's, and the ranks' own arrays under
    "ranks"."""
    path = str(tmp_path / "in.npz")
    np.savez(path, top_k=K, **data)
    launch.spawn(launch.moe_layer_worker, dp * ep,
                 (path, str(tmp_path), dp, ep, runs, "float32", "cpu"),
                 init_file=str(tmp_path / "store"), device="cpu")
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz"))
             for r in range(dp * ep)]
    out = {"ranks": ranks}
    for form, factor in runs:
        key = f"{form}@{factor}"
        got = {k: np.concatenate([ranks[i * ep][f"{key}/{k}"]
                                  for i in range(dp)]) for k in ("y", "dx")}
        for k in ("balance_loss", "drop_fraction", "drouter_w", "drouter_b"):
            got[k] = ranks[0][f"{key}/{k}"]
        for k in ("w1", "b1", "w2", "b2"):
            got["d" + k] = np.concatenate([ranks[j][f"{key}/d{k}"]
                                           for j in range(ep)])
        out[key] = got
    return out


def run_jax(form: str, dp: int, ep: int, data: dict, factor: float,
            monkeypatch, balance_weight=None) -> dict:
    """The JAX package's form on a dp x ep mesh: y, the aux values and the
    gradients of sum(y * c) + balance_weight * balance_loss (the data's
    weight unless given) by x and every parameter."""
    monkeypatch.setenv("SSMV_A2A_PERMUTED", "1" if form == "a2a_perm" else "0")
    def shard_buf(b):
        return constrain(b, (EXPERT_AXIS, None, None))

    fn = {"psum": jax_moe.moe_forward_fused_ep,
          "a2a": jax_moe.moe_forward_fused_ep_a2a,
          "a2a_perm": jax_moe.moe_forward_fused_ep_a2a,
          "sharded": lambda *a, **kw: jax_moe.moe_forward(
              *a, **kw, shard_buf=shard_buf),
          # the dropless forms: the ragged function under the mesh
          "ragged": lambda *a, capacity_factor, **kw:
              jax_moe.moe_forward_ragged(*a, **kw),
          "expert_choice": lambda *a, top_k, **kw:
              jax_moe.moe_forward_expert_choice(*a, **kw,
                                                shard_buf=shard_buf)}[form]
    w = {k: jnp.asarray(data[k]) for k in PARAMS}
    x, c = jnp.asarray(data["x"]), jnp.asarray(data["c"])
    bw = float(data["balance_weight"] if balance_weight is None
               else balance_weight)

    def loss(x, w):
        y, aux = fn(x, *(w[k] for k in PARAMS), top_k=K,
                    capacity_factor=factor)
        return jnp.sum(y * c) + bw * aux["balance_loss"], (y, aux)

    with jax.set_mesh(make_mesh(n_data=dp, n_expert=ep)):
        (_, (y, aux)), (dx, dw) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True))(x, w)
    out = {"y": y, "dx": dx, **aux, **{"d" + k: v for k, v in dw.items()}}
    return {k: np.asarray(v) for k, v in out.items()}


def assert_matches(got: dict, want: dict, what: str) -> None:
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=TOL, rtol=0,
                                   err_msg=f"{what}: {k}")


def assert_expert_group_replicated(ranks, ep: int, key: str) -> None:
    """y, dx and the aux values are bit-identical over each expert group
    (the ranks hold the same batch)."""
    for r, arrays in enumerate(ranks):
        lead = ranks[(r // ep) * ep]
        for k in ("y", "dx", "balance_loss", "drop_fraction", "drouter_w"):
            assert np.array_equal(arrays[f"{key}/{k}"], lead[f"{key}/{k}"]), \
                (key, k, r)



def import_worker(npz: str, out_dir: str, num_experts: int, ep: int,
                  device: str = "cpu") -> None:
    """One rank of a 1 x ``ep`` layout: ``resmoe_tiny_patch16_224_expert8``
    at 32 px with ``num_experts``, sharded, with an AdamW state and an EMA,
    restores the converted JAX checkpoint ``npz``; saves its parameters,
    EMA, optimizer state (``<field>/<name>``) and step as ``rank<r>.npz``."""
    import os

    import torch.distributed as dist

    from slim_switch_moe_vit_tpu_torch import create_model
    from slim_switch_moe_vit_tpu_torch import optim as torch_optim
    from slim_switch_moe_vit_tpu_torch.parallel import sharding
    from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
    from slim_switch_moe_vit_tpu_torch.utils.checkpoint import \
        restore_checkpoint

    mesh = sharding.make_mesh(1, ep)
    model = create_model("resmoe_tiny_patch16_224_expert8", num_classes=10,
                         img_size=32, num_experts=num_experts)
    sharding.shard_params(model, mesh)
    init, _ = torch_optim.make_optimizer(weight_decay=0.05)
    state = create_train_state(model, device=device, opt_init=init,
                               use_ema=True)
    restore_checkpoint(npz, state, mesh=mesh)
    out = {"step": np.asarray(state.step)}
    for name, p in model.named_parameters():
        out[f"param/{name}"] = p.detach().cpu().numpy()
        out[f"ema/{name}"] = state.ema_params[name].cpu().numpy()
        for k, v in state.optimizer.state[p].items():
            out[f"{k}/{name}"] = v.cpu().numpy()
    np.savez(os.path.join(out_dir, f"rank{dist.get_rank()}.npz"), **out)
