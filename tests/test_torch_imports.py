"""The port stands alone: it imports neither jax nor the reference
package, and its entry points refuse to run without a card unless the
caller asks for the CPU."""

import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

RUN_WITHOUT_JAX = """
import sys
from repro_torch import convert, core, kernels, planner  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.kernels import dequant, grouped_mvm, meta, ops, packed_canvas  # noqa: F401,E501
from repro_torch.models import get_model, moe, rwkv6, whisper  # noqa: F401
from repro_torch.launch import pack, serve  # noqa: F401
from repro_torch.models import transformer as T
from repro_torch.runtime import Engine, EngineConfig, poisson_trace, run_static

cfg = get_config("olmo-1b").reduced()
params = T.init_params(cfg, seed=0, device="cpu")
trace = poisson_trace(3, mean_interarrival=0.5, prompt_lens=(6, 10),
                      gen_lens=(3, 5), vocab_size=cfg.vocab_size, seed=0)
ecfg = EngineConfig(num_slots=2, page_size=8, num_pages=17,
                    max_pages_per_seq=8, prefill_bucket=8)
assert len(Engine(cfg, params, ecfg).run(trace).completed) == 3
trace = poisson_trace(3, mean_interarrival=0.5, prompt_lens=(6, 10),
                      gen_lens=(3, 5), vocab_size=cfg.vocab_size, seed=0)
assert len(run_static(cfg, params, trace, num_slots=2).completed) == 3
cfg = get_config("deepseek-v2-lite-16b").reduced()
params = get_model(cfg).init_params(cfg, seed=0, device="cpu")
for serve_once in (lambda t: Engine(cfg, params, ecfg).run(t),
                   lambda t: run_static(cfg, params, t, num_slots=2)):
    trace = poisson_trace(3, mean_interarrival=0.5, prompt_lens=(6, 10),
                          gen_lens=(3, 5), vocab_size=cfg.vocab_size, seed=0)
    assert len(serve_once(trace).completed) == 3
from repro_torch.runtime import encdec_extras_fn, vlm_extras_fn
for arch in ("qwen2-vl-7b", "rwkv6-7b"):
    cfg = get_config(arch).reduced()
    params = get_model(cfg).init_params(cfg, seed=0, device="cpu")
    trace = poisson_trace(
        3, mean_interarrival=0.5, prompt_lens=(6, 10), gen_lens=(3, 5),
        vocab_size=cfg.vocab_size, seed=0,
        extras_fn=vlm_extras_fn(cfg) if cfg.family == "vlm" else None)
    assert len(Engine(cfg, params, ecfg).run(trace).completed) == 3
for arch in ("olmoe-1b-7b", "whisper-tiny"):
    cfg = get_config(arch).reduced()
    params = get_model(cfg).init_params(cfg, seed=0, device="cpu")
    trace = poisson_trace(
        3, mean_interarrival=0.5, prompt_lens=(6, 10), gen_lens=(3, 5),
        vocab_size=cfg.vocab_size, seed=0,
        extras_fn=encdec_extras_fn(cfg) if cfg.family == "encdec" else None)
    assert len(run_static(cfg, params, trace, num_slots=2).completed) == 3
pack.check([pack.lm_packing(), pack.canvas_case(
    "lora_adapters_48x48", pack.lora_adapter_mats()), pack.canvas_case(
    "whisper_tiny_blocks", pack.whisper_mats()), pack.tpu_canvas("cpu"),
    pack.grouped_case("cpu"),
    pack.end_to_end("lora_int4", pack.lora_adapter_mats(), 4, "cpu", seed=0,
                    precision="int4", bias=True, activation="gelu")])
from repro_torch.launch import cli  # noqa: F401
from repro_torch.planner import residency  # noqa: F401
from repro_torch.runtime import (FaultSchedule, FleetConfig, FleetEngine,
                                 ModelPool, PoolConfig, PoolEngineConfig,
                                 PooledEngine, arena, dma, fault_tolerance,
                                 fleet, model_pool, multi_tenant_trace)
zoo = [(a, get_config(a).reduced(), s) for a, s in
       (("olmo-1b", 2.0), ("rwkv6-7b", 1.0))]
params = {a: get_model(c).init_params(c, seed=0, device="cpu")
          for a, c, _ in zoo}
tenants = [dict(model_id=a, vocab_size=c.vocab_size, share=s)
           for a, c, s in zoo]
pcfg = PoolConfig(hbm_budget_bytes=700 << 10, reload_bytes_per_step=32 << 10,
                  device_dma=True, dma_device="cpu")
pecfg = PoolEngineConfig(num_slots=2, page_size=8, num_pages=17,
                         max_pages_per_seq=8, prefill_bucket=8,
                         stream="layer")
pool = ModelPool(pcfg)
for a, c, s in zoo:
    pool.register(a, c, demand=s)
trace = multi_tenant_trace(tenants, 4, mean_interarrival=0.5,
                           prompt_lens=(6, 10), gen_lens=(3, 5), seed=0)
assert len(PooledEngine(pool, params, pecfg).run(trace).completed) == 4
trace = multi_tenant_trace(tenants, 4, mean_interarrival=0.5,
                           prompt_lens=(6, 10), gen_lens=(3, 5), seed=0)
rep = FleetEngine(zoo, pcfg, pecfg, params, FleetConfig(n_replicas=2),
                  faults=FaultSchedule.parse("kill@2:r0")).run(trace)
assert rep.requests_lost == 0 and len(rep.completed) == 4
import tempfile
import torch
from repro_torch import checkpoint, data, optim  # noqa: F401
from repro_torch.launch import steps, train  # noqa: F401
cfg, params, opt, stream, step = train.build(
    "olmo-1b", reduced=True, seq_len=16, batch=2, lr=3e-4, steps=1,
    microbatches=1, device="cpu")
params, opt, m = step(params, opt, stream.batch(0))
assert int(opt.step) == 1 and bool(torch.isfinite(m["loss"]))
with tempfile.TemporaryDirectory() as d:
    checkpoint.CheckpointManager(d).save(1, (params, opt))
    (_, opt2), n = checkpoint.CheckpointManager(d).restore((params, opt))
    assert n == 1 and torch.equal(opt2.m["embed"], opt.m["embed"])
from repro_torch.launch import dryrun, mesh, sharding  # noqa: F401
assert dryrun.run_cell("command-r-35b", "decode_32k", False)["ok"]
with mesh.make_host_mesh("cpu") as host:
    assert host.shape == {"data": 1, "model": 1} and host.backend == "gloo"
    with mesh.installed(host):
        cfg = get_config("command-r-35b").reduced()
        specs = sharding.param_pspecs(T.init_params(cfg, device="meta"), host)
        params = T.init_params(cfg, 0, device="cpu",
                               local=sharding.local_init(specs, host))
        assert len(run_static(cfg, params, poisson_trace(
            2, mean_interarrival=0.5, prompt_lens=(6,), gen_lens=(3,),
            vocab_size=cfg.vocab_size, seed=0), num_slots=2).completed) == 2
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("clean")
"""


def test_port_runs_without_importing_jax_or_the_reference():
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", RUN_WITHOUT_JAX], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr


def test_no_port_source_imports_jax_or_the_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.M)
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    hits = [f"{f}: {m.group(0).strip()}" for f in files
            for m in pat.finditer(f.read_text())]
    assert not hits, hits


def test_entry_points_refuse_to_run_without_cuda(monkeypatch):
    """No card and no explicit CPU request: raise, never fall back."""
    from repro_torch.configs import get_config
    from repro_torch.convert import canvas_from_jax, params_from_jax
    from repro_torch.launch import pack, serve
    from repro_torch.models import moe, rwkv6
    from repro_torch.models import transformer as T

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--mode", "engine"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--mode", "static"])
    with pytest.raises(RuntimeError, match="CUDA"):
        T.init_params(get_config("olmo-1b").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "deepseek-v2-lite-16b", "--mode", "engine"])
    with pytest.raises(RuntimeError, match="CUDA"):
        moe.init_params(get_config("deepseek-v2-lite-16b").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "whisper-tiny", "--mode", "static"])
    for arch in ("qwen2-vl-7b", "rwkv6-7b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--arch", arch])
    with pytest.raises(RuntimeError, match="CUDA"):
        rwkv6.init_params(get_config("rwkv6-7b").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "recurrentgemma-9b", "--mode", "static"])
    for mode in ("pool", "fleet"):
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--mode", mode])
    from repro_torch.runtime import DeviceDmaChannel, ModelPool, PoolConfig
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceDmaChannel(1024)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelPool(PoolConfig(hbm_budget_bytes=1 << 20, device_dma=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"embed": [[0.0]]})
    with pytest.raises(RuntimeError, match="CUDA"):
        pack.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        canvas_from_jax(None, [[0], [0], [1], [1]])
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--steps", "1"])


def test_state_constructors_default_to_the_card(monkeypatch):
    """The cache constructors run on the card unless given a device, as
    init_params does: without a card they raise instead of quietly
    building a CPU cache."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import griffin, moe, rwkv6, whisper
    from repro_torch.models import transformer as T

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hybrid = get_config("recurrentgemma-9b").reduced()
    dense = get_config("olmo-1b").reduced()
    mla = get_config("deepseek-v2-lite-16b").reduced()
    gqa = get_config("olmoe-1b-7b").reduced()
    for make in (lambda: T.init_paged_decode_state(dense, 4, 8),
                 lambda: T.init_decode_state(dense, 2, 8),
                 lambda: T.init_decode_state(
                     get_config("qwen2-vl-7b").reduced(), 2, 8),
                 lambda: L.paged_cache_init(2, 4, 8, 2, 16),
                 lambda: moe.init_decode_state(mla, 2, 8),
                 lambda: moe.init_decode_state(gqa, 2, 8),
                 lambda: moe.init_paged_decode_state(mla, 4, 8),
                 lambda: whisper.init_decode_state(
                     get_config("whisper-tiny").reduced(), 2, 8),
                 lambda: rwkv6.init_decode_state(
                     get_config("rwkv6-7b").reduced(), 2),
                 lambda: griffin.init_decode_state(hybrid, 2),
                 lambda: griffin.init_paged_decode_state(hybrid, 2, 4, 8),
                 lambda: griffin.init_params(hybrid)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    st = moe.init_decode_state(gqa, 2, 8, device="cpu")
    assert st.kv.shape == (2, 2, 2, 8, 2, 16) and st.kv.device.type == "cpu"
    st = rwkv6.init_decode_state(get_config("rwkv6-7b").reduced(), 2,
                                 device="cpu")
    assert st.wkv.shape == (2, 2, 4, 16, 16)
    assert st.wkv.dtype == torch.bfloat16 and st.wkv.device.type == "cpu"
    st = T.init_decode_state(dense, 2, 8, device="cpu")
    assert st.k.shape == (2, 2, 8, 2, 16) and st.pos == 0
    assert st.v.dtype == torch.bfloat16 and st.v.device.type == "cpu"


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """chip_smoke.py exits non-zero and prints no result both here (no
    card) and alone in a directory without the rest of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real")
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = subprocess.run([sys.executable, str(tmp_path / "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120,
                       cwd=tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout
