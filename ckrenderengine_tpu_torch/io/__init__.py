"""Scene IO: state chunks, scene files and DDS/DXT textures (the
reference's ``io`` package)."""

from .statechunk import CKStateChunk
from .serialize import LoadScene, SaveScene, load_object, save_object
