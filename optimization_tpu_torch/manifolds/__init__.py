from .base import Manifold
from .euclidean import EUCLIDEAN, euclidean
from .sphere import SPHERE, sphere
