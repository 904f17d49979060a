"""``repro_torch.launch.serve --mode static`` against the reference's
lockstep static mode (``repro.launch.serve.run_static``), for every
family both packages serve, reduced, on the CPU; and ``--mode pool`` and
``--mode fleet`` against the reference's ``run_pool`` / ``run_fleet`` on
the same flags (their own random weights: the ledgers do not depend on
the tokens, which are sampled).

The two draw their prompts (and whisper's frames, qwen2-vl's patches)
and their temperature samples from different generators (a
``torch.Generator`` against ``jax.random``), so they are held on
structure, not on tokens: the same printed lines (the header, the
prefill/decode timing line, up to two ``seqN`` rows of ``--gen`` tokens
in the vocabulary, ``ok``), ``--gen`` decode steps, and the state's
leaf shapes at the same ``--cache-len``. The reference's ``main`` builds
a host mesh and shards the params first; on this JAX its sharded
embedding gather raises, as ``tests/test_launch.py``'s host-mesh case
does, so the reference side runs its ``run_static`` on unsharded params.
"""

import argparse
import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import REGISTRY as JREGISTRY  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.steps import make_prefill_step  # noqa: E402
from repro.models import get_model as jget_model  # noqa: E402
from repro_torch.configs import REGISTRY, get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

SERVED = sorted(a for a in REGISTRY if a in JREGISTRY)
BATCH, PROMPT, GEN, CACHE = 3, 7, 4, 16
HEADER = re.compile(r"arch=(\S+) mode=static batch=(\d+) prompt=(\d+) "
                    r"gen=(\d+)$")
TIMING = re.compile(r"prefill: \d+\.\d ms   decode: \d+\.\d ms/token$")
ROW = re.compile(r"  seq(\d): \[([\d, ]*)\]$")


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny CPU ops: one intra-op thread avoids pool contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parse(out: str, vocab: int) -> tuple[str, list[list[int]]]:
    """The printed lines of one static run: (header, seq rows); asserts
    the timing line and the closing ``ok``."""
    lines = out.rstrip().splitlines()
    head = [i for i, ln in enumerate(lines) if HEADER.match(ln)]
    assert len(head) == 1, out
    lines = lines[head[0]:]
    assert TIMING.match(lines[1]), lines[1]
    rows = []
    for i, ln in enumerate(lines[2:-1]):
        m = ROW.match(ln)
        assert m and int(m.group(1)) == i, ln
        rows.append([int(t) for t in m.group(2).split(",")])
    assert lines[-1] == "ok"
    for row in rows:
        assert all(0 <= t < vocab for t in row), row
    return lines[0], rows


def _shapes(state) -> dict:
    """Leaf shapes of a state dataclass by field (an int position as the
    reference's int32 scalar)."""
    return {f.name: tuple(np.shape(getattr(state, f.name)))
            for f in dataclasses.fields(state)}


@pytest.mark.parametrize("arch", SERVED)
def test_static_mode_matches_the_reference_on_structure(arch, capsys,
                                                        monkeypatch):
    cfg, jcfg = get_config(arch).reduced(), jget(arch).reduced()
    steps = []
    api = get_model(cfg)

    def counting_decode(*a, **kw):
        steps.append(1)
        return api.decode_step(*a, **kw)

    monkeypatch.setattr(serve, "get_model", lambda c: dataclasses.replace(
        get_model(c), decode_step=counting_decode))
    assert serve.main(["--arch", arch, "--mode", "static", "--device", "cpu",
                       "--batch", str(BATCH), "--prompt-len", str(PROMPT),
                       "--gen", str(GEN), "--cache-len", str(CACHE)]) == 0
    mine = _parse(capsys.readouterr().out, cfg.vocab_size)
    assert len(steps) == GEN

    jp = jget_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    args = argparse.Namespace(seed=0, cache_len=CACHE, batch=BATCH,
                              prompt_len=PROMPT, gen=GEN, temperature=0.8)
    assert jserve.run_static(jcfg, jp, args) == 0
    ref = _parse(capsys.readouterr().out, jcfg.vocab_size)
    assert mine[0] == ref[0] == (f"arch={cfg.name} mode=static batch={BATCH}"
                                 f" prompt={PROMPT} gen={GEN}")
    assert [len(r) for r in mine[1]] == [len(r) for r in ref[1]] == \
        [GEN] * min(BATCH, 2)


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("cache_len", [0, 24])
def test_static_state_shapes_equal_the_reference(arch, cache_len):
    """The state the static mode decodes from, at ``--cache-len`` (0: the
    default, prompt + gen), has the reference's leaf shapes."""
    cfg, jcfg = get_config(arch).reduced(), jget(arch).reduced()
    n = cache_len or PROMPT + GEN
    batch = {"tokens": np.zeros((BATCH, PROMPT), np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = np.zeros((BATCH, cfg.encoder.seq_len, cfg.d_model),
                                   np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = np.zeros((BATCH, 4, cfg.d_model), np.float32)
    params = get_model(cfg).init_params(cfg, seed=0, device="cpu")
    _, state = get_model(cfg).prefill(
        cfg, params, {k: torch.as_tensor(v) for k, v in batch.items()}, n)
    jp = jax.eval_shape(lambda: jget_model(jcfg).init_params(
        jcfg, jax.random.PRNGKey(0)))
    _, jstate = jax.eval_shape(make_prefill_step(jcfg, n), jp,
                               {k: jnp.asarray(v) for k, v in batch.items()})
    assert _shapes(state) == _shapes(jstate)


def test_static_mode_draws_from_the_seed(capsys):
    """One ``torch.Generator`` seeded with ``--seed`` draws the prompts and
    the samples: the same seed prints the same rows, another seed other
    rows; ``--greedy`` takes the argmax."""
    argv = ["--arch", "recurrentgemma-9b", "--mode", "static", "--device",
            "cpu", "--batch", "2", "--prompt-len", "9", "--gen", "5"]
    rows = []
    for extra in ([], [], ["--seed", "3"], ["--greedy"]):
        assert serve.main(argv + extra) == 0
        rows.append(_parse(capsys.readouterr().out, 256)[1])
    assert rows[0] == rows[1]
    assert rows[2] != rows[0]
    cfg = get_config("recurrentgemma-9b").reduced()
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen,
                         dtype=torch.int32)
    logits, state = api.prefill(cfg, params, {"tokens": toks}, 14)
    want = []
    for _ in range(5):
        tok = logits.argmax(-1).to(torch.int32)
        want.append(tok)
        logits, state = api.decode_step(cfg, params, state, tok)
    assert rows[3] == torch.stack(want, 1).tolist()


# --- serve --mode pool | fleet ----------------------------------------------------

POOL_ARGV = ["--device", "cpu", "--batch", "6", "--requests", "18",
             "--prompt-len", "16", "--gen", "8", "--reload-kib-per-step",
             "32"]
FLEET_ARGV = ["--device", "cpu", "--zoo", "codeqwen1.5-7b:2,rwkv6-7b:1",
              "--requests", "12", "--reload-kib-per-step", "32", "--chaos",
              "kill@5:r0,dma@2:r1x4/20"]
WALL = ("wall_s", "decode_wall_s", "compile_wall_s", "prefill_wall_s",
        "tokens_per_s")
REQ = re.compile(r"  req(\d+) \[(\S+)\]: \[([\d, ]*)\]$")


def _blocks(out: str) -> tuple[list[str], list[dict]]:
    """A pool/fleet run's printed lines: its one-line rows and its JSON
    objects (each printed with indent=1), in order."""
    lines, objs, buf = [], [], None
    for ln in out.rstrip().splitlines():
        if buf is not None:
            buf.append(ln)
            if ln == "}":
                objs.append(json.loads("\n".join(buf)))
                buf = None
        elif ln == "{":
            buf = [ln]
        else:
            lines.append(ln)
    assert buf is None, out
    return lines, objs


def _no_wall(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in WALL}


def test_pool_mode_matches_the_reference(capsys):
    """``serve --mode pool`` (the default five-family zoo, reduced) prints
    the reference's lines: the clock, the residency plan, the header, the
    report and the arena, up to three request rows, ``ok``; the plan,
    report (wall clocks aside) and arena are equal, the request rows name
    the same requests and tenants with as many tokens."""
    assert serve.main(["--mode", "pool", *POOL_ARGV]) == 0
    mine = _blocks(capsys.readouterr().out)
    assert jserve.run_pool(serve.parse_args(["--mode", "pool",
                                             *POOL_ARGV])) == 0
    ref = _blocks(capsys.readouterr().out)
    (clock, head, *rows, ok), (plan, rep, arena) = mine
    (jclock, jhead, *jrows, jok), (jplan, jrep, jarena) = ref
    assert clock == jclock == "reload clock: 32768 B/step"
    assert head == jhead and ok == jok == "ok"
    assert head.startswith("zoo=codeqwen1.5-7b:2,qwen2-vl-7b:1,") and \
        " mode=pool policy=reload_aware stream=layer " in head
    assert plan == jplan and arena == jarena
    assert _no_wall(rep) == _no_wall(jrep)
    assert len(rows) == len(jrows) == 3
    for a, b in zip(rows, jrows):
        ma, mb = REQ.match(a), REQ.match(b)
        assert ma and mb and ma.group(1, 2) == mb.group(1, 2)
        assert len(ma.group(3).split(",")) == len(mb.group(3).split(","))
    assert rep["model_tokens"]["deepseek-v2-lite-16b"] > 0


def test_fleet_mode_matches_the_reference(capsys):
    """``serve --mode fleet`` under chaos prints the reference's lines and
    an equal fleet report: placement, failover and re-admissions, queue
    ages and every replica's row, no request lost."""
    assert serve.main(["--mode", "fleet", *FLEET_ARGV]) == 0
    mine = _blocks(capsys.readouterr().out)
    assert jserve.run_fleet(serve.parse_args(["--mode", "fleet",
                                              *FLEET_ARGV])) == 0
    ref = _blocks(capsys.readouterr().out)
    assert mine == ref
    (clock, head, ok), (rep,) = mine
    assert head == ("zoo=codeqwen1.5-7b:2,rwkv6-7b:1 mode=fleet replicas=2 "
                    "placement=demand chaos=kill@5:r0,dma@2:r1x4/20 "
                    "requests=12")
    assert rep["lost"] == 0 and rep["failovers"] == 1
    assert rep["re_admissions"] >= 1


def test_pool_modes_parse_the_reference_defaults():
    args = serve.parse_args(["--mode", "pool"])
    assert (args.zoo, args.policy, args.stream, args.slab_mode, args.quant,
            args.repartition, args.epoch_steps, args.max_bypass,
            args.slab_frac, args.hysteresis, args.rr_quantum,
            args.replicas, args.placement, args.chaos,
            args.reload_kib_per_step, args.hbm_budget_kib) == (
        "codeqwen1.5-7b:2,qwen2-vl-7b:1,rwkv6-7b:1,recurrentgemma-9b:1,"
        "deepseek-v2-lite-16b:1", "reload_aware", "layer", "full", "off",
        "off", 64, 64, 0.5, 32, 16, 2, "demand", "", 0, 0)
    assert serve.parse_zoo("a:2,b") == jserve.parse_zoo("a:2,b") == \
        [("a", 2.0), ("b", 1.0)]
    assert args.requests == 12 and args.device == "cuda"


def test_full_zoo_that_cannot_fit_the_card_raises_first(monkeypatch):
    """At ``--full`` the zoo's weight bytes are held against the card's
    free memory before anything is allocated: the default five-family
    zoo (96.2 GB of bf16 weights) cannot fit one H100."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *a: (79 * 10 ** 9, 85 * 10 ** 9))
    with pytest.raises(RuntimeError, match=r"96\.23 GB .* 79\.00 GB free"):
        serve.main(["--mode", "pool", "--full"])
    with pytest.raises(RuntimeError, match="GB free"):
        serve.main(["--mode", "fleet", "--full"])


class _Parsed(Exception):
    """Carries the namespace an entry point's parser produced."""


def _reference_args(monkeypatch, argv) -> argparse.Namespace:
    """The reference's ``serve.main`` flags for ``argv``, as its own parser
    reads them (its ``main`` parses inline, then builds a mesh): the
    parse is intercepted before anything runs."""
    parse = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        raise _Parsed(parse(self, args, namespace))
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed) as got:
        jserve.main(argv)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    return got.value.args[0]


@pytest.mark.parametrize("argv", [
    ["--mesh", "host"],
    ["--mesh", "host", "--mode", "static", "--batch", "3", "--gen", "4"],
    ["--mesh", "pod", "--mode", "pool", "--policy", "round_robin"]])
def test_serve_parses_the_reference_mesh_flag(monkeypatch, argv):
    """``--mesh`` takes the reference's choices and default (host): every
    flag the reference's parser reads, the port's reads the same (the
    port's parser already turns ``--requests`` 0 into 3 x ``--batch``,
    which the reference does after parsing)."""
    want = vars(_reference_args(monkeypatch, argv))
    got = vars(serve.parse_args(argv))
    assert want["mesh"] == argv[1] and want["requests"] == 0
    want["requests"] = 3 * want["batch"]
    assert {k: got[k] for k in want} == want
    assert serve.parse_args([]).mesh == "host"
    with pytest.raises(SystemExit):
        serve.parse_args(["--mesh", "multipod"])


def test_serve_runs_on_the_host_mesh_and_refuses_pod(capsys):
    """``--mesh host`` (the reference's default spelled out) serves as
    without the flag, through the 1x1 mesh; ``--mesh pod`` raises in a
    world of one rank, naming the 256 ranks its mesh needs."""
    argv = ["--mode", "static", "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--gen", "3", "--greedy"]
    assert serve.main(["--mesh", "host", *argv]) == 0
    header, rows = _parse(capsys.readouterr().out,
                          get_config("codeqwen1.5-7b").vocab_size)
    assert header.startswith("arch=codeqwen1.5-7b") and len(rows) == 2
    with pytest.raises(RuntimeError, match="256 ranks"):
        serve.main(["--mesh", "pod", *argv])
