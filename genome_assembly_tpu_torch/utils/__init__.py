from .tracing import Tracer, global_tracer, profile, stage

__all__ = ["Tracer", "global_tracer", "profile", "stage"]
