"""The port's examples (``examples_torch/``) against the reference's
(``examples/``), on the CPU.

- collective_playground: the reference script and the port's
  (``--device cpu``) print the same table, line for line, at 16 ranks
  in pods of 4 and at 12 in pods of 3 (a non-power-of-two, where some
  builders do not apply);
- quickstart: the port's script (8 gloo ranks it starts itself), its
  group form on 8 gloo ranks in torchrun's environment (both
  transports) and its one-card form (the transport kernel's plain
  version) print the reference's lines; the one-card form's ``"xla"``
  line carries its note.  Random float32 inputs with negative zeros
  through both forms: each schedule's result bitwise the reference's
  ``SimTransport.run_reference`` on the reference's schedule (``"auto"``
  resolved by the reference's selector), ``"xla"`` within float32
  rounding of the sum, the neighbor exchange bitwise the reference's
  ``run_sim`` on the reference's plan;
- serve_batch: the reference's loop (``jax.jit(make_decode_step(...))``
  on a one-device mesh, ``init_params(key(0))`` and the cache cast to
  float32, the requests of ``key(1)``) against ``run`` with the same
  weights (``convert.params_from_jax``) and requests in float32: the
  same generated tokens, every step's logits within ``atol = rtol =
  1e-4`` (the f32 tolerance of tests/test_torch_model.py);
- train_smollm: ``--steps 6`` yields 6 losses and the loss falls; a run
  with checkpoints every 3 steps, cut after step 3's, resumes at 3 with
  the straight run's losses bitwise, and a run past ``--steps`` does
  nothing; a ``--full`` run after a smoke run in the default
  checkpoint directory trains from step 0; on 8 gloo ranks every rank has the same losses, within 1e-2
  of the one-rank run (the explicit-DP tolerance of
  tests/test_torch_train_launcher.py);
- each script exits non-zero with ``--device cuda`` and no card;
- importing a script runs nothing and loads no ``jax``, ``repro`` or
  ``ml_dtypes``.
"""
import json
import os
import pickle
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro_torch.checkpoint import committed_steps
from repro_torch.launch.mesh import free_port

sys.path.insert(0, os.path.dirname(__file__))
import torch_examples_worker as worker  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ("collective_playground", "quickstart", "serve_batch",
           "train_smollm")
PLAYGROUND_TOPOS = [(16, 4), (12, 3)]
NRANKS = 8
TRAIN = dict(steps=6, ckpt_every=3)


def _env():
    env = dict(os.environ)
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return env


def _start(*args) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _lines(proc: subprocess.Popen) -> list:
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-3000:]
    return out.splitlines()


def _neg_zeros(a: np.ndarray) -> np.ndarray:
    a.reshape(-1)[::7] = -0.0
    return a


def _random_inputs():
    rng = np.random.default_rng(11)
    x = _neg_zeros(rng.normal(size=(NRANKS, 37)).astype(np.float32))
    values = _neg_zeros(rng.normal(size=(NRANKS, 4, 3)).astype(np.float32))
    return x, values


QUICKSTART_CASES = {"dist": "dist", "kernel": "kernel",
                    "random-dist": "dist", "random-kernel": "kernel"}


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """Everything that runs in other processes, started together: the
    reference scripts, the port's quickstart script, and the 8-rank
    spawn of tests/torch_examples_worker.py."""
    tmp = tmp_path_factory.mktemp("examples")
    procs = {("playground", n, p): _start(
        "examples/collective_playground.py", "--nranks", str(n),
        "--ranks-per-pod", str(p)) for n, p in PLAYGROUND_TOPOS}
    procs["quickstart"] = _start("examples/quickstart.py")
    procs["quickstart_port"] = _start("examples_torch/quickstart.py",
                                      "--device", "cpu")
    x, values = _random_inputs()
    cases = {name: (tr, x if name.startswith("random") else None,
                    values if name.startswith("random") else None)
             for name, tr in QUICKSTART_CASES.items()}
    train = dict(TRAIN, ckpt_dir=str(tmp / "ckpt8"))
    ctx = torch.multiprocessing.start_processes(
        worker.run, args=(NRANKS, free_port(), cases, train, str(tmp)),
        nprocs=NRANKS, join=False, start_method="spawn")
    yield {"procs": procs, "ctx": ctx, "dir": tmp}
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()
        p.join(timeout=30)


@pytest.fixture(scope="module")
def spawned(background):
    ctx = background["ctx"]
    deadline = time.monotonic() + 600
    while not ctx.join(timeout=5):
        assert time.monotonic() < deadline, "the 8 ranks did not finish"
    outs = []
    for r in range(NRANKS):
        with open(background["dir"] / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# collective_playground
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nranks,per_pod", PLAYGROUND_TOPOS)
def test_playground_table_equals_reference(background, capsys, nranks,
                                           per_pod):
    pg = worker.load("collective_playground")
    res = pg.main(["--device", "cpu", "--nranks", str(nranks),
                   "--ranks-per-pod", str(per_pod)])
    got = capsys.readouterr().out.splitlines()
    want = _lines(background["procs"][("playground", nranks, per_pod)])
    assert got == want == res["lines"]
    assert len(res["kernel_allgathers"]) == sum(
        line.startswith("allgather ") for line in want) >= 5


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def quickstart_ref(background):
    lines = _lines(background["procs"]["quickstart"])
    assert len(lines) == 7 and lines[-1] == "quickstart OK"
    return lines


def test_quickstart_script_prints_the_reference_lines(background,
                                                      quickstart_ref):
    assert _lines(background["procs"]["quickstart_port"]) == quickstart_ref


@pytest.mark.parametrize("transport", ["dist", "kernel"])
def test_quickstart_group_form_lines(spawned, quickstart_ref, transport):
    assert spawned[0]["quickstart"][transport]["lines"] == quickstart_ref
    for o in spawned[1:]:
        assert o["quickstart"][transport]["lines"] == []


def test_quickstart_one_card_form_lines(capsys, quickstart_ref):
    qs = worker.load("quickstart")
    res = qs.run_one_card(torch.device("cpu"))
    assert capsys.readouterr().out.splitlines() == res["lines"]
    want = [quickstart_ref[0] + qs.ONE_CARD_XLA] + quickstart_ref[1:]
    assert res["lines"] == want


def _reference_results(x: np.ndarray, values: np.ndarray) -> dict:
    """Each allreduce algorithm's per-rank result through the reference's
    SimTransport oracle on the reference's schedule, and the reference
    neighbor plan's per-rank recv rows (``run_sim``)."""
    from repro.core import selector
    from repro.core.algorithms import REGISTRY
    from repro.core.plan import CommGraph, build_plan, run_sim
    from repro.core.topology import Topology
    from repro.core.transport import SimTransport

    topo = Topology(nranks=NRANKS, ranks_per_pod=4)
    width = x.shape[1]
    pad = -width % NRANKS
    gbuf = np.pad(x, ((0, 0), (0, pad))).reshape(NRANKS, NRANKS, -1)
    out = {}
    for algo in ("ring_rs_ag", "hierarchical", "auto"):
        name = (selector.select("allreduce", topo, width * 4, policy="model")
                if algo == "auto" else algo)
        sched = REGISTRY["allreduce"][name](topo)
        res = SimTransport(NRANKS).run_reference(sched, gbuf)
        out[algo] = (name, res.reshape(NRANKS, -1)[:, :width])
    graph = CommGraph.random(NRANKS, n_local=4, degree=3,
                             rng=np.random.default_rng(0), dup_frac=0.8)
    plan = build_plan(graph, topo, aggregate=True)
    out["recv"] = run_sim(plan, list(values))
    out["recv_sizes"] = plan.recv_sizes
    return out


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("form", ["group-dist", "group-kernel", "one-card"])
def test_quickstart_random_inputs_bitwise(spawned, form):
    x, values = _random_inputs()
    ref = _reference_results(x, values)
    if form == "one-card":
        res = worker.load("quickstart").run_one_card(torch.device("cpu"), x=x,
                                               values=values)
        per_rank = [{a: res["allreduce"][a][r] for a in res["allreduce"]}
                    for r in range(NRANKS)]
        recv = res["recv"]
        assert res["algorithms"]["auto"] == ref["auto"][0]
    else:
        outs = [o["quickstart"]["random-" + form[6:]] for o in spawned]
        per_rank = [o["allreduce"] for o in outs]
        recv = outs[0]["recv"]
        for o in outs[1:]:
            assert np.array_equal(_bits(o["recv"]), _bits(recv))
    for r, got in enumerate(per_rank):
        for algo, (name, want) in ((a, ref[a]) for a in
                                   ("ring_rs_ag", "hierarchical", "auto")):
            assert np.array_equal(_bits(got[algo][0]), _bits(want[r])), \
                (form, algo, name, r)
        np.testing.assert_allclose(got["xla"][0], x.astype(np.float64).sum(0),
                                   rtol=1e-6, atol=1e-6)
    m = max(ref["recv_sizes"])
    assert recv.shape == (NRANKS * m, values.shape[2])
    for r, want in enumerate(ref["recv"]):
        assert np.array_equal(_bits(recv[r * m: r * m + len(want)]),
                              _bits(want)), (form, r)


# ---------------------------------------------------------------------------
# serve_batch
# ---------------------------------------------------------------------------


def _f32(tree):
    return jax.tree.map(lambda a: a.astype(jnp.float32)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, tree)


def test_serve_batch_matches_reference_loop(capsys):
    from repro import compat
    from repro import configs as jconfigs
    from repro.models import model as JM
    from repro.serve.step import ServeOptions as JOptions
    from repro.serve.step import make_decode_step as jmake

    from repro_torch.convert import params_from_jax
    from repro_torch.models import model as M

    sb = worker.load("serve_batch")
    jcfg = jconfigs.get_smoke(sb.ARCH)
    B, P, G = sb.BATCH, sb.PROMPT, sb.GEN
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    with compat.set_mesh(mesh):
        jp = _f32(JM.init_params(jax.random.key(0), jcfg))
        reqs = jax.random.randint(jax.random.key(1), (B, P), 2,
                                  jcfg.vocab_size)
        cache = _f32(JM.init_cache(jcfg, B, P + G))
        decode = jax.jit(jmake(jcfg, mesh, JOptions()))
        logits_of = jax.jit(lambda p, c, t: JM.decode_step(p, jcfg, c,
                                                           t)[0][:, -1])
        tok, want_logits, want_gen = reqs[:, :1], [], []
        for i in range(P + G - 1):
            want_logits.append(np.asarray(logits_of(jp, cache, tok)))
            nxt, cache = decode(jp, cache, tok)
            tok = reqs[:, i + 1: i + 2] if i + 1 < P else nxt
            if i + 1 >= P:
                want_gen.append(np.asarray(nxt)[:, 0])
    cfg = sb.configs.get_smoke(sb.ARCH)
    params = M.from_state(cfg, params_from_jax(jax.tree.map(np.asarray, jp)))
    res = sb.run(cfg, B, P, G, torch.device("cpu"), params=params,
                 requests=torch.from_numpy(np.array(reqs)).long(),
                 dtype=torch.float32, keep_logits=True)
    assert capsys.readouterr().out.splitlines() == res["lines"]
    assert np.array_equal(res["tokens"].numpy(), np.stack(want_gen, 1))
    assert res["logits"].shape == (P + G - 1, B, cfg.vocab_size)
    for i, want in enumerate(want_logits):
        np.testing.assert_allclose(res["logits"][i].numpy(), want,
                                   atol=1e-4, rtol=1e-4, err_msg=f"step {i}")
    assert len(res["step_ms"]) == P + G - 1


def test_serve_batch_main_prints_the_reference_lines(capsys):
    import re
    res = worker.load("serve_batch").main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines == res["lines"] and len(lines) == 2
    assert re.fullmatch(r"batch=8 prompt=24 gen=24: \d+\.\d ms/step, "
                        r"\d+ tok/s aggregate", lines[0]), lines[0]
    assert lines[1] == "serve_batch OK"
    assert res["tokens"].shape == (8, 24)


# ---------------------------------------------------------------------------
# train_smollm
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    d = tmp_path_factory.mktemp("smollm")
    run = worker.load("train_smollm").run(**TRAIN, ckpt_dir=str(d), device="cpu")
    return run, d


def test_train_smollm_one_rank(one_rank):
    run, _ = one_rank
    assert run.start_step == 0 and len(run.losses) == TRAIN["steps"]
    assert np.isfinite(run.losses).all()
    assert run.losses[-1] < run.losses[0], run.losses


def test_train_smollm_resume_bitwise(one_rank):
    straight, d = one_rank
    ts = worker.load("train_smollm")
    assert sorted(committed_steps(d)) == [3, 6]
    shutil.rmtree(d / "step_00000006")       # cut after step 3's
    resumed = ts.run(**TRAIN, ckpt_dir=str(d), device="cpu")
    assert resumed.start_step == 3
    assert resumed.losses == straight.losses[3:]
    again = ts.main(["--device", "cpu", "--steps", "6", "--ckpt-every", "3",
                     "--ckpt-dir", str(d)])
    assert again.start_step == 6 and again.losses == []


def test_train_smollm_full_after_smoke_in_the_default_dir(monkeypatch,
                                                          tmp_path):
    """The default checkpoints live under $TMPDIR, one directory per
    config: a ``--full`` run after a smoke run trains its own steps from
    step 0.  The full config is mapped to the smoke one for the CPU;
    only the directory differs between the two runs."""
    import tempfile

    from repro_torch import configs
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    ts = worker.load("train_smollm")
    flags = ["--device", "cpu", "--steps", str(TRAIN["steps"]),
             "--ckpt-every", str(TRAIN["steps"])]
    smoke = ts.main(flags)
    assert smoke.start_step == 0 and len(smoke.losses) == TRAIN["steps"]
    monkeypatch.setattr(configs, "get_config", configs.get_smoke)
    full = ts.main(flags + ["--full"])
    assert full.start_step == 0 and len(full.losses) == TRAIN["steps"]
    for name in ("smoke", "full"):
        assert committed_steps(tmp_path / f"repro_torch_smollm_{name}") == [
            TRAIN["steps"]]


def test_train_smollm_eight_ranks(spawned, one_rank):
    runs = [o["train"] for o in spawned]
    for o in runs:
        assert o["start"] == 0 and o["losses"] == runs[0]["losses"]
    assert np.isfinite(runs[0]["losses"]).all()
    np.testing.assert_allclose(runs[0]["losses"], one_rank[0].losses,
                               atol=1e-2)


# ---------------------------------------------------------------------------
# every script
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SCRIPTS)
def test_no_card_exits(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        worker.load(name).main(["--device", "cuda"])
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)


def test_import_runs_nothing_and_loads_no_jax():
    code = f"""
import importlib.util, json, sys
mods = {{}}
for name in {list(SCRIPTS)!r}:
    spec = importlib.util.spec_from_file_location(
        "ex_" + name, {str(ROOT / "examples_torch")!r} + "/" + name + ".py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mods[name] = callable(getattr(mod, "main", None))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes"))
print(json.dumps({{"mains": mods, "bad": bad}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1, lines           # nothing printed at import
    res = json.loads(lines[0])
    assert res == {"mains": {n: True for n in SCRIPTS}, "bad": []}
