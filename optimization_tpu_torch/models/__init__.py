from . import graph, matrix_completion, rotation_sync
