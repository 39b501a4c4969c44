"""The multi-mode engine: plans, backends, the op API and whole-network
programs (`compile` -> `CompiledNet`)."""
from repro_torch.engine.api import conv2d, dense, einsum, matmul
from repro_torch.engine.config import (EngineConfig, current_config,
                                       using_backend, using_config)
from repro_torch.engine.dispatch import (EngineBackend, get_backend,
                                         register_backend)
from repro_torch.engine.ledger import Ledger, tracking
from repro_torch.engine.plan import (EnginePlan, OpSpec, dense_spec,
                                     parse_einsum, plan_conv2d, plan_einsum,
                                     plan_op, supports_int8, with_precision)
from repro_torch.engine.program import (CompiledNet, NetworkPlan, Program,
                                        compile, plan_network)

__all__ = [
    "CompiledNet", "EngineBackend", "EngineConfig", "EnginePlan", "Ledger",
    "NetworkPlan", "OpSpec", "Program", "compile", "conv2d",
    "current_config", "dense", "dense_spec", "einsum", "get_backend",
    "matmul", "parse_einsum", "plan_conv2d", "plan_einsum", "plan_network",
    "plan_op", "register_backend", "supports_int8", "tracking",
    "using_backend", "using_config", "with_precision",
]
