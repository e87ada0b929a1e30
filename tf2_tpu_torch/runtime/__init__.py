from .engine import Engine
