"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX
package (every module, the layer tier ``layers/``, the sequence-parallel
modules ``ops/ring_attention.py``, ``ops/ulysses.py`` and
``models/sp_transformer.py``, the KV handoff stream ``ops/kv_stream.py`` and
the optimizer transforms ``optim.py``, and the modules the 2-D rank runtime reaches
— the runtime, the pair collectives, the hierarchical EP layers, the
models, decode and the engine — included), its entry
points run on the card unless the caller asks for the CPU (and raise with
no card; the KV stream on a runtime on the card never runs its plain
version on CPU tensors), its layers hold no parameters of their own, and ``chip_smoke.py``
refuses to report without a card or without the port beside it."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from triton_dist_tpu_torch.models import decode as tdec
from triton_dist_tpu_torch.models import tp_transformer as ttm
from triton_dist_tpu_torch.serving import engine as teng

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "triton_dist_tpu_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import triton_dist_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'triton_dist_tpu'))\n"
        "assert len(names) >= 15, names\n"
        "new = {'triton_dist_tpu_torch.ops.ring_attention', 'triton_dist_tpu_torch.ops.ulysses',\n"
        "       'triton_dist_tpu_torch.models.sp_transformer', 'triton_dist_tpu_torch.ops.kv_stream',\n"
        "       'triton_dist_tpu_torch.optim'}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "two_d = {'triton_dist_tpu_torch.' + m for m in (\n"
        "    'parallel.mesh', 'utils', 'ops.common', 'ops.allgather', 'ops.allgather_gemm',\n"
        "    'ops.reduce_scatter', 'ops.gemm_reduce_scatter', 'ops.grads', 'ops.all_to_all',\n"
        "    'layers.tp_mlp', 'layers.allgather_layer', 'layers.ep_a2a_layer',\n"
        "    'layers.ep_moe_mlp', 'models.tp_transformer', 'models.presets', 'models.decode',\n"
        "    'serving.engine', 'resilience.records', 'resilience.sites', 'resilience.watchdog')}\n"
        "assert two_d <= set(names), sorted(two_d - set(names))\n"
        "layers = [n for n in names if n.startswith('triton_dist_tpu_torch.layers.')]\n"
        "assert len(layers) == 5, layers\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_source_names_jax_or_the_jax_package():
    """An AST scan, so an import behind a branch or inside a function that
    the subprocess import never reaches is caught too."""
    offenders = []
    for path in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py", ROOT / "chip_phases.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [
                f"{path.relative_to(ROOT)}: {n}" for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "triton_dist_tpu")
            ]
    assert not offenders, offenders


def test_default_device_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ttm.TransformerConfig(vocab=16, hidden=16, ffn=32, n_layers=1,
                                n_q_heads=2, n_kv_heads=1, head_dim=8, batch=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttm.init_params(cfg)
    params = ttm.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.ContinuousBatcher(cfg, params, s_max=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.ServingEngine(cfg, params, s_max=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.generate(cfg, params, [[1, 2]], 2, s_max=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdec.ContinuousBatcher(cfg, params, s_max=8, device="cuda")
    from triton_dist_tpu_torch.parallel.mesh import initialize_distributed

    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize_distributed(mesh_shape={"dp": 2, "tp": 2})
    from triton_dist_tpu_torch.ops import kv_stream as tkv

    slab = torch.ones(8, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkv.kv_stream_op(slab, ctx=initialize_distributed(2, device="cuda"))
    # a runtime that says it lies on the card: the wrapper raises, it does not
    # exchange CPU tensors over the plain version
    ctx = initialize_distributed(2, device="cpu")
    ctx.cuda = True
    calls = tkv._kv_stream_xla.calls
    with pytest.raises(ValueError, match="a runtime on the card takes card tensors"):
        tkv.kv_stream(slab, ctx=ctx)
    assert tkv._kv_stream_xla.calls == calls
    # asked for explicitly, the CPU runs the plain versions
    b = tdec.ContinuousBatcher(cfg, params, s_max=8, device="cpu")
    b.submit(tdec.Request([1, 2], max_new_tokens=2, uid="x"))
    assert [uid for uid, _ in b.run()] == ["x"]


def test_layers_take_their_weights_per_call():
    """The layer tier's modules are the JAX package's names (``ElasticStep``
    still to port) and own no parameters or buffers: like the JAX layers
    they take their weights per call; ``HierEPAll2AllLayer`` carries the
    reference's fields."""
    from triton_dist_tpu_torch import layers

    assert [n for n in dir(layers) if n[0].isupper()] == [
        "AllGatherLayer", "EPAll2AllLayer", "EPMoEMLP", "HierEPAll2AllLayer",
        "SpGQAFlashDecodeAttention", "TPMLP", "TPMoEMLP"]
    for layer in (layers.AllGatherLayer(), layers.SpGQAFlashDecodeAttention(),
                  layers.TPMLP(), layers.TPMoEMLP(overlap=False), layers.EPMoEMLP(8, 2, 4)):
        assert isinstance(layer, torch.nn.Module)
        assert not list(layer.parameters()) and not list(layer.buffers())
    hier = layers.HierEPAll2AllLayer(n_experts=8, topk=2, max_m1=4, max_m2=8)
    assert (hier.outer, hier.inner, hier.quant, hier.a2a_config) == ("dp", "tp", None, None)


def test_chip_smoke_refuses_without_a_card_or_the_port(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                          env=_env(), capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
