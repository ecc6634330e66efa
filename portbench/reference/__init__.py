"""The plain reference of the benchmark's configurations.

Plain PyTorch in float32, with TF32 off: the MoE Vision Transformer's
forward (patch embedding, attention, top-k routed experts, LayerNorm, the
head), the label-smoothed loss, AdamW and the EMA, and the serving
normalisation. It imports nothing of the program, and its backward is
PyTorch's autograd over its own forward. ``model.matmul_fp8`` puts its
products in fp8 (the precision below the configurations' bf16): the
comparison's control.
"""
