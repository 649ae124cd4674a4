from .flat_cg import (FlatCGInit, FlatCGResult, SphereStepAux,
                      flat_init_dots, sphere_rayleigh_flat,
                      sphere_rayleigh_step, stpcg_flat)
from .stpcg import STPCGResult, stpcg
from .jacobi import jacobi_eigh
from .lobpcg import LOBPCGResult, lobpcg, lobpcg_fleet, rayleigh_ritz
from .lsqr import LSQRResult, lsqr
