"""The port stands without JAX and without the JAX package.

A subprocess blocks ``jax``, ``flax``, ``optax`` and ``tubedetr_tpu`` in
``sys.modules``, imports every module of ``tubedetr_tpu_torch`` (the int8
modules ``ops/int8_conv.py``, ``ops/fused_bottleneck.py`` and
``models/quantize.py``, and the probes' ``ops/probe_mm.py``,
``ops/probe_bottleneck.py`` and ``probes/`` among them) and ``chip_smoke``,
and serves one tiny
request on the CPU with the float backbone and one with the int8_static +
fused one, calibration included. An AST scan checks
that no port file or ``chip_smoke.py`` names those modules in an import
(module names compared whole: ``tubedetr_tpu_torch`` is not
``tubedetr_tpu``). ``chip_smoke.py`` without a card, or alone in a
directory, exits non-zero and prints no result.
"""

import ast
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "flax", "optax", "tubedetr_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "tubedetr_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_in_port_source(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in BLOCKED]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_port_imports_and_serves_with_jax_blocked(tmp_path):
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        for name in {BLOCKED!r}:
            sys.modules[name] = None
        sys.path.insert(0, {ROOT!r})
        import numpy as np
        import tubedetr_tpu_torch, chip_smoke
        for mod in pkgutil.walk_packages(tubedetr_tpu_torch.__path__, "tubedetr_tpu_torch."):
            importlib.import_module(mod.name)
        from tubedetr_tpu_torch.apps.pipeline import GroundingPipeline
        from tubedetr_tpu_torch.config import TubeDETRConfig
        cfg = TubeDETRConfig(
            backbone="resnet14", hidden_dim=32, nheads=4, enc_layers=1, dec_layers=1,
            dim_feedforward=64, video_max_len=6, video_max_len_train=6, stride=2,
            resolution=128, max_text_len=8, text_vocab_size=128, text_hidden_size=32,
            text_layers=1, text_heads=4, text_ffn=64, text_max_positions=40,
            guided_attn=False, aux_loss=False, dropout=0.0,
        )
        path = {str(tmp_path / "clip.npy")!r}
        np.save(path, np.random.RandomState(0).randint(0, 256, (6, 48, 64, 3), dtype=np.uint8))
        out = GroundingPipeline(cfg, device="cpu").ground(path, "a red square", render=False)
        s, e = out["sted"]
        assert 0 <= s < e <= 6 and len(out["boxes"]) == 6
        q = GroundingPipeline(cfg.replace(backbone="resnet26", backbone_quant="int8_static",
                                          fused_bottleneck=True), device="cpu")
        out = q.ground(path, "a red square", render=False)
        assert not q._needs_calibration and len(out["boxes"]) == 6
        assert not any(m.split(".")[0] in {BLOCKED!r} for m, v in sys.modules.items() if v)
        print("SERVED", out["sted"])
    """)
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          timeout=300, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED" in proc.stdout


def test_new_int8_modules_are_scanned():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for mod in ("ops/int8_conv.py", "ops/fused_bottleneck.py", "models/quantize.py",
                "ops/probe_mm.py", "ops/probe_bottleneck.py", "probes/__init__.py",
                "probes/int8_matmul.py", "probes/fused_variants.py", "probes/mm_ablations.py",
                "apps/serve.py", "apps/demo.py", "apps/cli.py", "eval/viou.py",
                "data/annotations.py", "data/synthetic.py", "losses/matcher.py",
                "losses/criterion.py", "train/optim.py", "train/engine.py", "train/logging.py",
                "train/checkpoint.py", "parallel/train_step.py"):
        assert os.path.join("tubedetr_tpu_torch", mod) in names


@pytest.mark.parametrize("alone", [False, True], ids=["in-repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_package(tmp_path, alone):
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=120, cwd=str(tmp_path), env=env)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
