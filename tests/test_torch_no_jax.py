"""The port stands without JAX and without the JAX package.

A subprocess blocks ``jax``, ``flax``, ``optax`` and ``tubedetr_tpu`` in
``sys.modules``, imports every module of ``tubedetr_tpu_torch`` (the int8
modules ``ops/int8_conv.py``, ``ops/fused_bottleneck.py`` and
``models/quantize.py``, the probes' ``ops/probe_mm.py``,
``ops/probe_bottleneck.py`` and ``probes/``, and the data pipeline and the
train CLI among them) and ``chip_smoke``, builds the port's staging library
from its own source into a fresh path and runs it, serves one tiny request
on the CPU with the float backbone and one with the int8_static + fused
one, calibration included, and trains one tiny CLI epoch over a VidSTG-
layout directory. An audit hook in that process records every file it
opens, every program it starts and every library it loads: none lies inside
``tubedetr_tpu/``. An AST scan checks that no port file or
``chip_smoke.py`` names those modules in an import (module names compared
whole: ``tubedetr_tpu_torch`` is not ``tubedetr_tpu``), and a second scan
that no string in their code (docstrings aside) and no line of the port's
C++ and CUDA sources (comments aside) names a path inside ``tubedetr_tpu/``
(the JAX package's ``native/staging.cc`` among them): the port builds only
its own copies. ``chip_smoke.py`` without a card, or alone in a directory,
exits non-zero and prints no result.
"""

import ast
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "flax", "optax", "tubedetr_tpu")


def _port_files(suffixes=(".py",)):
    files = [os.path.join(ROOT, "chip_smoke.py")] if ".py" in suffixes else []
    for dirpath, dirs, names in os.walk(os.path.join(ROOT, "tubedetr_tpu_torch")):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
        files += [os.path.join(dirpath, n) for n in names if n.endswith(suffixes)]
    return sorted(files)


# a path inside the JAX package: ``tubedetr_tpu`` as a whole path component
JAX_PATH = re.compile(r"(^|[^\w.])tubedetr_tpu($|[/\\])")
CITATION = re.compile(r"[\w/.]+\.py:\d+")


def _code_strings(path):
    """The string constants of a Python file, docstrings left out."""
    tree = ast.parse(open(path).read(), filename=path)
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


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


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_path_into_the_jax_package_in_port_code(path):
    """A ``file.py:line`` citation (the ``replaces`` of a kernel's entry in
    ``chip_smoke.py``'s result line) names the TPU kernel a port replaces,
    no file to read."""
    bad = [v for v in _code_strings(path)
           if JAX_PATH.search(v) and not CITATION.fullmatch(v)]
    assert not bad, f"{os.path.relpath(path, ROOT)} names {bad}"


def test_no_path_into_the_jax_package_in_port_native_sources():
    sources = _port_files((".cc", ".cu", ".cuh"))
    assert os.path.join(ROOT, "tubedetr_tpu_torch", "native", "staging.cc") in sources
    for path in sources:
        for i, line in enumerate(open(path)):
            code = line.split("//", 1)[0]
            assert not JAX_PATH.search(code), f"{os.path.relpath(path, ROOT)}:{i + 1}: {line}"


def test_port_imports_and_serves_with_jax_blocked(tmp_path):
    jax_dir = os.path.join(ROOT, "tubedetr_tpu") + os.sep
    script = textwrap.dedent(f"""
        import importlib, os, pkgutil, sys
        touched = []

        def audit(event, args):
            if event in ("open", "subprocess.Popen", "ctypes.dlopen", "os.exec", "os.posix_spawn"):
                for a in args:
                    for s in (a if isinstance(a, (list, tuple)) else [a]):
                        if isinstance(s, (str, bytes, os.PathLike)):
                            p = os.path.abspath(os.fsdecode(s)) if event != "subprocess.Popen" \\
                                else os.fsdecode(s)
                            if {jax_dir!r} in p + os.sep or p.startswith({jax_dir!r}):
                                touched.append((event, p))

        sys.addaudithook(audit)
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
        from tubedetr_tpu_torch.data import native
        native.SO_PATH = {str(tmp_path / "build" / "libstaging.so")!r}
        frames = np.random.RandomState(1).randint(0, 256, (3, 12, 16, 3), dtype=np.uint8)
        eye = np.eye(12, dtype=np.float32), np.eye(16, dtype=np.float32)
        np.testing.assert_allclose(native.resize_normalize_clip(frames, *eye),
                                   native.resize_normalize_clip(frames, *eye, plain=True), atol=1e-5)
        assert os.path.exists(native.SO_PATH)
        from tubedetr_tpu_torch.apps import train
        from tubedetr_tpu_torch.data.synthetic import write_vidstg_dir
        data = write_vidstg_dir({str(tmp_path / "vidstg")!r}, 2, 1, t=6, h=48, w=64,
                                video_max_len_train=6)
        args = ["--combine_datasets", "vidstg", "--combine_datasets_val", "vidstg",
                "--vidstg_ann_path", data, "--vidstg_vid_path", data, "--backbone", "resnet14",
                "--hidden_dim", "32", "--nheads", "4", "--enc_layers", "1", "--dec_layers", "1",
                "--dim_feedforward", "64", "--video_max_len", "6", "--video_max_len_train", "6",
                "--stride", "2", "--resolution", "128", "--max_text_len", "8",
                "--text_vocab_size", "128", "--text_hidden_size", "32", "--text_layers", "1",
                "--text_heads", "4", "--text_ffn", "64", "--epochs", "1", "--device", "cpu",
                "--num_workers", "2", "--device_prefetch", "2", "--ema",
                "--output-dir", {str(tmp_path / "out")!r}]
        assert train.main(args) == 0
        assert not touched, touched
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
                "train/checkpoint.py", "parallel/train_step.py", "data/native.py",
                "data/datasets.py", "data/loader.py", "data/preproc.py", "data/transforms.py",
                "data/decode.py", "data/collate.py", "apps/train.py", "utils/misc.py"):
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
