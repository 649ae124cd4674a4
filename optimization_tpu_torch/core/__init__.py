from . import debug, problem, tree, types
