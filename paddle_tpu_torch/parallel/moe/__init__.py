from .gate import GShardGate, NaiveGate, SwitchGate, TopKGateOutput  # noqa: F401
from .grad_clip import ClipGradForMOEByGlobalNorm  # noqa: F401
from .layer import ExpertMLP, ExpertSwiGLU, MoELayer  # noqa: F401
