"""Serving: export the eval forward as an artifact + predict.

See ``export.py`` (artifact, bucketed batches) and ``server.py`` (dynamic
batcher + HTTP endpoint).
"""
from .export import (  # noqa: F401
    Predictor,
    export_model,
    load_predictor,
    make_serve_fn,
)
from .server import DynamicBatcher, make_server  # noqa: F401
