"""The multi-mode engine: plans, backends, the op API, whole-network
programs (`compile` -> `CompiledNet`) and the kernel autotuner (`tune`)."""
from repro_torch.engine import tune  # noqa: F401
from repro_torch.engine.api import (conv1d_depthwise, conv2d, dense, einsum,
                                    matmul, paged_gather, proj)
from repro_torch.engine.config import (EngineConfig, current_config,
                                       default_backend, in_config_context,
                                       set_default_config, using_backend,
                                       using_config)
from repro_torch.engine.dispatch import (EngineBackend, backend_names,
                                         get_backend, register_backend)
from repro_torch.engine.ledger import Ledger, is_tracking, tracking
from repro_torch.engine.plan import (PRECISIONS, EnginePlan, OpSpec,
                                     auto_backend, dense_spec, parse_einsum,
                                     plan_conv1d_depthwise, plan_conv2d,
                                     plan_einsum, plan_gather, plan_op,
                                     supports_int8, with_precision)
from repro_torch.engine.program import (CompiledNet, NetworkPlan, Program,
                                        compile, infer_batch_axes,
                                        plan_network, trace_program)
from repro_torch.kernels.epilogue import ACT_CODES

# Activations the GEMM kernels apply in their epilogue (others, such as
# silu, stay plain ops after the GEMM).
EPILOGUE_ACTS = frozenset(a for a in ACT_CODES if a is not None)

__all__ = [
    "CompiledNet", "EngineBackend", "EngineConfig", "EnginePlan",
    "Ledger", "NetworkPlan", "OpSpec", "PRECISIONS",
    "Program", "auto_backend", "backend_names", "compile",
    "conv1d_depthwise", "conv2d", "current_config", "default_backend",
    "dense", "dense_spec", "einsum", "get_backend",
    "in_config_context", "infer_batch_axes", "is_tracking", "matmul",
    "paged_gather", "parse_einsum", "plan_conv1d_depthwise", "plan_conv2d",
    "plan_einsum", "plan_gather", "plan_network", "plan_op", "proj",
    "register_backend", "set_default_config", "supports_int8",
    "trace_program", "tracking", "using_backend", "using_config",
    "with_precision", "EPILOGUE_ACTS",
]
