"""Serving: the shape-bucketed, multi-scene RenderEngine."""
from repro_torch.serve.engine import (BucketKey, RenderEngine,  # noqa: F401
                                      RenderRequest, Ticket)
