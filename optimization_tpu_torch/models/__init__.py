from . import (graph, matrix_completion, pose_sync, range_sync,
               rotation_sync)
