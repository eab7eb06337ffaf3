"""The high-level API: ``Model`` (prepare / fit / evaluate / predict /
save / load), its callbacks and ``summary``."""
from . import callbacks
from .model import Model
from .summary import flops, summary

__all__ = ["callbacks", "Model", "summary", "flops"]
