"""The benchmark of the PyTorch and CUDA port,
``slim_switch_moe_vit_tpu_torch``.

``python portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card it is
started on; ``README.md`` beside this file says what each part does.
"""
