from .geometry import (
    BOUNDARY, MeshAdjacency, MeshStriper, NearestPointGrid, NvStripifier,
    PlaceFitter, RadixSorter, VertexCache, VertexCacheOptimizer,
    strip_to_triangles,
)
from . import native
