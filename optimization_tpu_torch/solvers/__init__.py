from . import euclidean, gradient_descent, tnls, tnt
from .euclidean import euclidean_gradient_descent, euclidean_tnls, euclidean_tnt
