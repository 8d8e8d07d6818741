"""The PyTorch port imports no JAX: an ``ast`` walk over every module of
``penroz_tpu_torch`` and over ``chip_smoke.py`` finds no import of
``jax``, ``jaxlib``, ``optax`` or ``penroz_tpu``."""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "optax", "penroz_tpu"}


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((ROOT / "penroz_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10 and files[-1].exists()
    bad = [f"{f.relative_to(ROOT)}:{line} imports {mod}"
           for f in files for line, mod in _imported_roots(f)
           if mod in FORBIDDEN]
    assert not bad, bad


def test_port_modules_import():
    import importlib
    for f in sorted((ROOT / "penroz_tpu_torch").rglob("*.py")):
        rel = f.relative_to(ROOT).with_suffix("")
        parts = [p for p in rel.parts if p != "__init__"]
        importlib.import_module(".".join(parts))


def test_training_slice_modules_import_without_a_card():
    """The training slice's modules import on a host without nvcc or a
    card: their kernels are built and loaded only when launched."""
    import importlib
    for name in ("penroz_tpu_torch.ops.kernels.flash_attention",
                 "penroz_tpu_torch.ops.kernels.cross_entropy",
                 "penroz_tpu_torch.ops.losses",
                 "penroz_tpu_torch.data.loaders"):
        module = importlib.import_module(name)
        assert (ROOT / (name.replace(".", "/") + ".py")).exists()
        assert module.__doc__
    from penroz_tpu_torch.ops.kernels import build
    assert "flash_attention" not in build._LIBS
    assert "cross_entropy" not in build._LIBS
    for src in ("flash_attention.cu", "cross_entropy.cu"):
        assert (ROOT / "penroz_tpu_torch" / "csrc" / src).exists()


def test_ssm_slice_modules_import_without_a_card():
    """The hybrid slice's modules import on a host without nvcc or a card:
    the chunked-GLA kernel is built and loaded only when launched."""
    import importlib
    for name in ("penroz_tpu_torch.ops.kernels.ssm_scan",
                 "penroz_tpu_torch.ops.ssm"):
        module = importlib.import_module(name)
        assert (ROOT / (name.replace(".", "/") + ".py")).exists()
        assert module.__doc__
    from penroz_tpu_torch.ops.kernels import build
    assert "ssm_scan" not in build._LIBS
    assert (ROOT / "penroz_tpu_torch" / "csrc" / "ssm_scan.cu").exists()
