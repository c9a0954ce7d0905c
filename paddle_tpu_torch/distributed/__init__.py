from . import meta_parallel

__all__ = ["meta_parallel"]
