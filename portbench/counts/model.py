"""The model's FLOPs, for MFU: the matrix products of the forward, 2 FLOPs
per multiply-add (attention's scores and mix included, which the program's
``ops/flops.py`` counts in multiply-adds), over routed rows, without
elementwise work. A training step counts 3 forwards."""
from __future__ import annotations


def forward_flops_per_image(cfg: dict) -> float:
    D, H, E, k = (cfg["embed_dim"], cfg["hidden"], cfg["num_experts"],
                  cfg["top_k"])
    P = cfg["patch_size"]
    n_patches = (cfg["img_size"] // P) ** 2
    N = n_patches + 1
    f = 2.0 * n_patches * (P * P * 3) * D          # patch embedding
    block = (2.0 * N * D * 3 * D                    # qkv
             + 4.0 * N * N * D                      # scores + mix
             + 2.0 * N * D * D                      # proj
             + 2.0 * N * D * E                      # router
             + 4.0 * N * k * D * H)                 # k experts, two GEMMs
    f += cfg["depth"] * block
    f += 2.0 * D * cfg["num_classes"]               # head
    return f


def train_step_flops(cfg: dict, batch: int) -> float:
    return 3.0 * batch * forward_flops_per_image(cfg)


def serve_batch_flops(cfg: dict, batch: int) -> float:
    return batch * forward_flops_per_image(cfg)
