from . import euclidean, gradient_descent, tnt
from .euclidean import euclidean_gradient_descent, euclidean_tnls, euclidean_tnt
