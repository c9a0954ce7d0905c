from . import meta_parallel
from .mesh import Mesh, all_gather, ppermute, psum, psum_scatter

__all__ = ["meta_parallel", "Mesh", "psum", "all_gather", "ppermute",
           "psum_scatter"]
