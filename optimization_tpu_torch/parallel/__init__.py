from . import collectives, consensus, mesh, sharding
from .mesh import (BATCH, MODEL, batch_mesh, initialize_distributed,
                   make_mesh, model_mesh)
