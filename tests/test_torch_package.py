"""Package boundaries of the PyTorch/CUDA port.

* No module of ``dhts_torch`` and not ``chip_smoke.py`` imports JAX, flax,
  optax or the JAX package ``dhts`` (AST scan of every import).
* The CUDA sources include no PyTorch header and nothing calls
  ``torch.utils.cpp_extension``.
* Entry points raise without a GPU unless the caller passes
  ``device="cpu"``.
"""

import ast
from pathlib import Path

import pytest
import torch

# small tensors: one intra-op thread is fastest and leaves the cores to
# the other test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "dhts_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dhts"}


def imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_dhts(path):
    bad = FORBIDDEN & set(imported_roots(path))
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_port_module_list_is_complete():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("dhts_torch/ops/arz.py", "dhts_torch/ops/idm.py",
                "dhts_torch/ops/dmath.py", "dhts_torch/models/network.py",
                "dhts_torch/models/conversion.py",
                "dhts_torch/apps/control/itscp/env.py",
                "dhts_torch/ops/cuda/itscp_hybrid_episode.py",
                "dhts_torch/apps/control/trainer.py",
                "dhts_torch/apps/control/itscp/run.py",
                "chip_smoke.py"):
        assert mod in names, mod


def test_cuda_sources_use_no_pytorch_headers_or_builder():
    sources = list((ROOT / "dhts_torch").rglob("*.cu")) + list(
        (ROOT / "dhts_torch").rglob("*.cuh")) + list(
        (ROOT / "dhts_torch").rglob("*.h"))
    assert sources
    for src in sources:
        text = src.read_text()
        for banned in ("torch/extension.h", "ATen/", "c10/", "pybind11"):
            assert banned not in text, (src, banned)
    for path in PORT_FILES:
        assert "cpp_extension" not in path.read_text(), path


def test_build_names_library_by_content():
    from dhts_torch.ops.cuda import _build

    path = _build.library_path("itscp_hybrid_episode")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libitscp_hybrid_episode_")
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_entry_points_need_a_gpu_unless_told_cpu():
    from dhts_torch import resolve_device
    from dhts_torch.apps.control.itscp.env import ItscpEnv

    cfg = dict(num_intersection=1, policy_length=2, random_seed=1)
    env = ItscpEnv(config=cfg, device="cpu")
    assert env.device.type == "cpu"
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert ItscpEnv(config=cfg).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ItscpEnv(config=cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ItscpEnv(config=cfg, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """Without CUDA, and alone in a directory, it exits non-zero and prints
    no result line."""
    import subprocess
    import sys

    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [subprocess.run([sys.executable, str(alone)], capture_output=True,
                           text=True, timeout=120, cwd=tmp_path)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py")],
            capture_output=True, text=True, timeout=120, cwd=ROOT))
    for proc in runs:
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
