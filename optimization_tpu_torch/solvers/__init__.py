from . import tnt
