from .actor_critic import GRActor, GRCritic
from .config import ModelConfig
from .convert import policy_params_from_flax
from .policy import GRMAPPOPolicy, PolicyDims, PolicyParams

__all__ = [
    "GRActor",
    "GRCritic",
    "GRMAPPOPolicy",
    "ModelConfig",
    "PolicyDims",
    "PolicyParams",
    "policy_params_from_flax",
]
