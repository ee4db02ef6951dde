from .tracing import Tracer, global_tracer, stage

__all__ = ["Tracer", "global_tracer", "stage"]
