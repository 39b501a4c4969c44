"""The multi-mode engine: plans, backends, the op API and whole-network
programs (`compile` -> `CompiledNet`)."""
from repro_torch.engine.api import (conv1d_depthwise, conv2d, dense, einsum,
                                    matmul, paged_gather, proj)
from repro_torch.engine.config import (EngineConfig, current_config,
                                       using_backend, using_config)
from repro_torch.engine.dispatch import (EngineBackend, get_backend,
                                         register_backend)
from repro_torch.engine.ledger import Ledger, tracking
from repro_torch.engine.plan import (EnginePlan, OpSpec, dense_spec,
                                     parse_einsum, plan_conv1d_depthwise,
                                     plan_conv2d, plan_einsum, plan_gather,
                                     plan_op, supports_int8, with_precision)
from repro_torch.engine.program import (CompiledNet, NetworkPlan, Program,
                                        compile, infer_batch_axes,
                                        plan_network, trace_program)
from repro_torch.kernels.epilogue import ACT_CODES

# Activations the GEMM kernels apply in their epilogue (others, such as
# silu, stay plain ops after the GEMM).
EPILOGUE_ACTS = frozenset(a for a in ACT_CODES if a is not None)

__all__ = [
    "CompiledNet", "EngineBackend", "EngineConfig", "EnginePlan", "Ledger",
    "NetworkPlan", "OpSpec", "Program", "compile", "conv1d_depthwise",
    "conv2d", "current_config", "dense", "dense_spec", "einsum",
    "get_backend", "infer_batch_axes", "matmul", "paged_gather", "parse_einsum",
    "plan_conv1d_depthwise", "plan_conv2d", "plan_einsum", "plan_gather",
    "plan_network", "plan_op", "proj", "register_backend", "supports_int8",
    "trace_program", "tracking", "using_backend", "using_config",
    "with_precision", "EPILOGUE_ACTS",
]
