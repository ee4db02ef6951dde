from .runner import test_assembly

__all__ = ["test_assembly"]
