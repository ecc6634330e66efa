"""The optimizer's global norms on a 1 x 2 (data, expert) layout of gloo
ranks on the CPU: Lamb's global rescale and trust ratios and
``--clip-grad``'s global norm take the expert tensors' squares over the
expert group, so the ranks, each holding half the experts, land where one
process holding every expert lands (within the parity tolerance of
``tests/test_torch_optim_surface.py``)."""
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu_torch import optim
from torch_tmp import delete_module_tmp, delete_tmp_path  # noqa: F401

LR, WD = 1e-3, 0.05
REL, SLACK = 1e-6, 1e-4


@pytest.mark.parametrize("opt,clip", [("lamb", None), ("adamw", 0.5)])
def test_norms_under_expert_parallelism(opt, clip, tmp_path):
    """Lamb's global rescale and trust ratios, and ``--clip-grad``'s global
    norm, on a 1 x 2 (data, expert) layout of gloo ranks: one MoE layer
    (d 16, h 32, 4 experts) takes three steps, each rank holding 2 experts
    of the parameters and gradients. With the norms summed over the expert
    group (the driver's setting) the ranks land where one process holding
    every expert lands, within the parity tolerance, and their dense
    parameters are bit-identical; with each rank's own norms they do
    not land there."""
    from slim_switch_moe_vit_tpu_torch.models.moe import MoEMlp
    from slim_switch_moe_vit_tpu_torch.parallel import launch

    d, h, E = 16, 32, 4
    rs = np.random.RandomState(8)
    layer = MoEMlp(d, h, num_experts=E)
    layer.init_weights(torch.Generator().manual_seed(8))
    with torch.no_grad():  # biases away from 0, so every norm is positive
        for p in (layer.router_bias, layer.b1, layer.b2):
            p.copy_(torch.from_numpy(rs.randn(*p.shape).astype(np.float32)))
    model = torch.nn.Module()
    model.mlp = layer
    params = {n: p.detach().numpy().copy()
              for n, p in model.named_parameters()}
    data = {"dims": np.array([d, h, E]), "lr": np.float32(LR),
            **{f"param/{n}": v for n, v in params.items()}}
    grads = []
    for s in range(3):
        grads.append({n: (rs.randn(*v.shape) * 0.1).astype(np.float32)
                      for n, v in params.items()})
        data.update({f"grad{s}/{n}": g for n, g in grads[-1].items()})
    kw = dict(opt=opt, weight_decay=WD, clip_grad=clip)
    init, update = optim.make_optimizer(**kw)
    single = init(model)
    for g in grads:
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        update(single, LR, LR)
    want = {n: p.detach().numpy() for n, p in model.named_parameters()}
    np.savez(tmp_path / "in.npz", **data)
    for group_norms in (True, False):
        out = tmp_path / str(group_norms)
        out.mkdir()
        launch.spawn(launch.optimizer_steps_worker, 2,
                     (str(tmp_path / "in.npz"), str(out), 1, 2, kw,
                      group_norms, "cpu"),
                     init_file=str(out / "store"), device="cpu")
        ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
        errs = []
        for n, w in want.items():
            got = (np.concatenate([r[n] for r in ranks])
                   if ranks[0][n].shape != w.shape else ranks[0][n])
            if group_norms and ranks[0][n].shape == w.shape:
                assert np.array_equal(ranks[0][n], ranks[1][n]), n
            errs.append(np.abs(got - w).max()
                        / (REL * np.abs(w).max() + SLACK * LR))
        assert (max(errs) <= 1.0) == group_norms, (group_norms, max(errs))
