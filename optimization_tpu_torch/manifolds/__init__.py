from .base import Manifold
from .euclidean import EUCLIDEAN, euclidean
from .grassmann import GRASSMANN, grassmann
from .product import product
from .sphere import SPHERE, sphere
from .stiefel import ROTATIONS, STIEFEL, rotations, stiefel
