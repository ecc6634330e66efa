"""Which optimizer path the train step takes (``engine.fused_optimizer``).

The step takes the optimizer's one-pass form, ``update_fn.fused_apply``
(K7: AdamW and the EMA in one launch), wherever the optimizer has one
(adamw without ``clip_grad`` or a trainable mask) and the model's trainable
parameters are CUDA f32 tensors; otherwise ``update_fn`` and
``ema_update``. ``use_fused_optimizer`` requires the fused form: on the CPU
its plain version, and a ``ValueError`` where there is none. The leaves
here are stubs that carry what the choice reads (no card is needed), or
CPU tensors.
"""
import types

import pytest
import torch

from slim_switch_moe_vit_tpu_torch import engine, optim


def _leaf(device="cuda", dtype=torch.float32, trainable=True):
    if device == "cpu":
        return torch.zeros(2, dtype=dtype).requires_grad_(trainable)
    return types.SimpleNamespace(is_cuda=True, dtype=dtype,
                                 requires_grad=trainable)


class _Model:
    def __init__(self, leaves):
        self.leaves = leaves

    def parameters(self):
        return iter(self.leaves)


CUDA_F32 = [_leaf(), _leaf()]
CASES = {
    # name: (make_optimizer kwargs, leaves, the fused form taken by default)
    "adamw_cuda_f32": ({}, CUDA_F32, True),
    "adamw_cuda_f32_frozen_bf16": (
        {}, CUDA_F32 + [_leaf(dtype=torch.bfloat16, trainable=False)], True),
    "sgd": ({"opt": "sgd"}, CUDA_F32, False),
    "lamb": ({"opt": "lamb"}, CUDA_F32, False),
    "adam": ({"opt": "adam"}, CUDA_F32, False),
    "clip_grad": ({"clip_grad": 1.0}, CUDA_F32, False),
    "trainable_mask": ({"trainable_mask": optim.attn_only_mask}, CUDA_F32,
                       False),
    "bf16_leaves": ({}, [_leaf(), _leaf(dtype=torch.bfloat16)], False),
    "cpu_leaves": ({}, [_leaf("cpu"), _leaf("cpu")], False),
    "no_trainable_leaves": ({}, [_leaf(trainable=False)], False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_the_step_takes_the_fused_form_on_cuda_f32_adamw(case):
    kw, leaves, fused = CASES[case]
    _, update = optim.make_optimizer(**kw)
    has_form = hasattr(update, "fused_apply")
    assert has_form == (not kw), case  # adamw alone has a fused form
    model = _Model(leaves)
    got = engine.fused_optimizer(update, model)
    assert got is (update.fused_apply if fused else None), case
    if has_form:  # required: taken on any device, the plain one on the CPU
        assert engine.fused_optimizer(update, model, required=True) is \
            update.fused_apply
    else:
        with pytest.raises(ValueError, match="no fused form"):
            engine.fused_optimizer(update, model, required=True)
        with pytest.raises(ValueError, match="no fused form"):
            engine.make_train_step(torch.nn.Linear(2, 2), update, None,
                                   use_fused_optimizer=True)
