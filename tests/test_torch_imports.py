"""The PyTorch port imports no JAX: an ``ast`` walk over every module of
``penroz_tpu_torch`` and over ``chip_smoke.py`` finds no import of
``jax``, ``jaxlib``, ``optax`` or ``penroz_tpu``, nor of ``transformers``,
``safetensors``, ``huggingface_hub`` or ``ml_dtypes``, which the machine
with the card does not have either; a process where those cannot be
imported imports a HuggingFace checkpoint."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
HF_PACKAGES = {"transformers", "safetensors", "huggingface_hub", "ml_dtypes"}
FORBIDDEN = {"jax", "jaxlib", "optax", "penroz_tpu"} | HF_PACKAGES


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


def test_hf_import_runs_without_the_hf_packages(tmp_path):
    """``from_huggingface`` in a process where ``transformers``,
    ``safetensors``, ``huggingface_hub``, ``ml_dtypes`` and JAX cannot be
    imported (``sys.modules`` entries of None)."""
    import torch
    from transformers import Qwen3Config, Qwen3ForCausalLM
    torch.manual_seed(0)
    model = Qwen3ForCausalLM(Qwen3Config(
        vocab_size=64, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, num_key_value_heads=1, head_dim=8,
        intermediate_size=32, tie_word_embeddings=True)).eval()
    model.to(torch.bfloat16).save_pretrained(tmp_path / "ckpt",
                                             safe_serialization=True)
    blocked = sorted(HF_PACKAGES | {"jax", "jaxlib", "optax", "penroz_tpu"})
    script = f"""
import os, sys
for name in {blocked!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(ROOT)!r})
os.chdir({str(tmp_path)!r})
from penroz_tpu_torch.utils import checkpoint
checkpoint.SHM_PATH = {str(tmp_path / "shm")!r}
os.makedirs(checkpoint.SHM_PATH)
from penroz_tpu_torch.models.model import NeuralNetworkModel
m = NeuralNetworkModel.from_huggingface("q", "ckpt", device="cpu")
tokens = m.generate_tokens([1, 2, 3], 8, 3, temperature=0)
checkpoint.join_flushes()
print(m.status["code"], len(tokens))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-2:] == ["Imported", "6"]


def test_lora_slice_modules_run_without_jax(tmp_path):
    """``models/lora.py`` and ``serve/adapters.py`` in a process where JAX
    and ``penroz_tpu`` cannot be imported: create an adapter of a toy
    model, load it through the registry and generate with it."""
    blocked = sorted({"jax", "jaxlib", "optax", "penroz_tpu"})
    script = f"""
import os, sys
for name in {blocked!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(ROOT)!r})
os.chdir({str(tmp_path)!r})
from penroz_tpu_torch.utils import checkpoint
checkpoint.SHM_PATH = {str(tmp_path / "shm")!r}
os.makedirs(checkpoint.SHM_PATH)
from penroz_tpu_torch.models import lora, presets
from penroz_tpu_torch.models.dsl import Mapper
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.serve import adapters
m = NeuralNetworkModel("m", Mapper(presets.gpt2_custom(
    d=16, heads=2, depth=1, vocab=32, block=8), presets.ADAMW),
    device="cpu")
lora.create_adapter("a", m, {{"rank": 2}}, seed=1, init="random")
entry = adapters.REGISTRY.acquire("a", "m")
tokens = lora.bind_model(m, entry.params, entry.config).generate_tokens(
    [1, 2, 3], 8, 3, temperature=0)
checkpoint.join_flushes()
print(sorted(adapters.list_adapters()[0]), len(tokens))
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2].endswith(" 6")
    assert "'adapter_id'" in out.stdout


def test_router_slice_modules_run_without_jax(tmp_path):
    """``serve/router.py`` and the engine's hand-off seam in a process where
    JAX and ``penroz_tpu`` cannot be imported: a 2-replica group with
    disaggregated prefill serves one request through an export and an
    import."""
    blocked = sorted({"jax", "jaxlib", "optax", "penroz_tpu"})
    script = f"""
import os, sys
for name in {blocked!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(ROOT)!r})
os.chdir({str(tmp_path)!r})
os.environ.update(PAGED_KV_CACHE="1", PENROZ_KV_PAGE_SIZE="4",
                  PENROZ_SCHED_REPLICAS="2", PENROZ_DISAGG_PREFILL="1",
                  PENROZ_MEMLEDGER_STRICT="1")
from penroz_tpu_torch.utils import checkpoint
checkpoint.SHM_PATH = {str(tmp_path / "shm")!r}
os.makedirs(checkpoint.SHM_PATH)
from penroz_tpu_torch.models import presets
from penroz_tpu_torch.models.dsl import Mapper
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.serve import decode_scheduler as ds
from penroz_tpu_torch.serve import router
m = NeuralNetworkModel("m", Mapper(presets.gpt2_custom(
    d=16, heads=2, depth=1, vocab=32, block=16), presets.ADAMW),
    device="cpu")
m.serialize(sync_flush=True)
group = ds.get_engine("m", 16, 0.0, None, device="cpu")
assert isinstance(group, router.EngineRouter)
tokens = ds.run_request(group, [1, 2, 3, 4, 5], 4, None, timeout=60)
stats = ds.serving_stats()
ds.reset()
print(len(tokens), stats["disagg_exports"], stats["disagg_imports"])
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "9 1 1"


def test_session_slice_modules_run_without_jax(tmp_path):
    """``serve/tierstore.py``, ``serve/journal.py`` and ``serve/streams.py``
    in a process where JAX and ``penroz_tpu`` cannot be imported: a session
    hibernates to the disk tier through the journal, the registry recovers
    it after an engine reset, a stream replays from its ring, and the
    wake imports the blob."""
    blocked = sorted({"jax", "jaxlib", "optax", "penroz_tpu"})
    script = f"""
import os, queue, sys, time
for name in {blocked!r}:
    sys.modules[name] = None
sys.path.insert(0, {str(ROOT)!r})
os.chdir({str(tmp_path)!r})
os.environ.update(PAGED_KV_CACHE="1", PENROZ_KV_PAGE_SIZE="4",
                  PENROZ_PREFIX_CACHE="1", PENROZ_TIER_HOST_MB="0",
                  PENROZ_TIER_DISK_PATH={str(tmp_path / "tier")!r},
                  PENROZ_JOURNAL_PATH={str(tmp_path / "wal")!r},
                  PENROZ_MEMLEDGER_STRICT="1")
from penroz_tpu_torch.utils import checkpoint
checkpoint.SHM_PATH = {str(tmp_path / "shm")!r}
os.makedirs(checkpoint.SHM_PATH)
from penroz_tpu_torch.models import presets
from penroz_tpu_torch.models.dsl import Mapper
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.serve import decode_scheduler as ds
from penroz_tpu_torch.serve import journal, streams, tierstore
m = NeuralNetworkModel("m", Mapper(presets.gpt2_custom(
    d=16, heads=2, depth=1, vocab=32, block=16), presets.ADAMW),
    device="cpu")
m.serialize(sync_flush=True)
engine = ds.get_engine("m", 16, 0.0, None, device="cpu")
req, events = ds.start_stream(engine, [1, 2, 3, 4, 5], 4, None,
                              request_id="r", session_id="s")
first = ds.collect(req, events, 60)
while (tierstore.TIERS.get("s") is None
       or tierstore.TIERS.get("s").tier != "disk"):
    time.sleep(0.01)
ring = streams.STREAMS.get("r").resume(queue.Queue(), 0)
ds.reset()
tierstore.TIERS._sessions.clear()
tierstore.TIERS._index.clear()
journal.JOURNAL.close()
recovered = tierstore.TIERS.recover()["sessions_recovered"]
engine = ds.get_engine("m", 16, 0.0, None, device="cpu")
second = ds.run_request(engine, first + [6], 2, None, timeout=60)
ds.reset()
print(len(ring), recovered, tierstore.TIERS.promotions[("disk", "ok")],
      second[:len(first)] == first)
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-2] == "5 1 1 True"


def test_train_worker_and_ssm_update_import_no_jax():
    """The training worker's module, which the server starts as its own
    process, and the recurrent-update kernel's wrapper load no JAX module
    in a fresh interpreter."""
    code = ("import sys; import penroz_tpu_torch.models.train_worker; "
            "import penroz_tpu_torch.ops.kernels.ssm_update; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)


def test_parallel_modules_import_no_jax():
    """``parallel/dist.py``, ``parallel/sharding.py`` and
    ``parallel/zero.py`` (training over ranks) load no JAX module and
    nothing of ``penroz_tpu`` in a fresh interpreter, and neither do the
    multi-rank tests' rank processes."""
    code = ("import sys; import penroz_tpu_torch.parallel.dist; "
            "import penroz_tpu_torch.parallel.sharding; "
            "import penroz_tpu_torch.parallel.zero; "
            "sys.path.insert(0, 'tests'); import _torch_rank_worker; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)
