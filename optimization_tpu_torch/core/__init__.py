from . import checkpoint, debug, driver, problem, tree, types
