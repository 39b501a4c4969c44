"""The port stands alone: no module of `src/repro_torch/` and not
`chip_smoke.py` imports JAX or the JAX package `repro`, and the port
imports without `triton`, `nvcc` or a GPU (kernels build at first use)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_port_imports_without_triton_nvcc_or_jax():
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"        # any import of triton fails
        "import repro_torch, repro_torch.engine, repro_torch.models.cnn\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
        "import repro_torch.kernels.build, repro_torch.kernels.paged\n"
        "import repro_torch.kernels.flash_attention, repro_torch.models.flash\n"
        "import repro_torch.configs.base, repro_torch.configs.smollm_135m\n"
        "import repro_torch.models.transformer, repro_torch.serve.kv_pool\n"
        "import repro_torch.serve.engine, repro_torch.serve.scheduler\n"
        "import repro_torch.launch.serve\n"
        "import repro_torch.configs.llama32_vision_11b\n"
        "import repro_torch.configs.gemma2_27b\n"
        "import repro_torch.configs.gemma3_27b, repro_torch.configs.qwen3_32b\n"
        "import repro_torch.configs.jamba15_large\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro')], 'jax or repro was imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"
