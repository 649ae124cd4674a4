from . import (admm, euclidean, gradient_descent, prox, proximal_gradient,
               tnls, tnt)
from .euclidean import euclidean_gradient_descent, euclidean_tnls, euclidean_tnt
