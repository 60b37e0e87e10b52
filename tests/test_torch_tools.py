"""The port's learning-check tool chain against the JAX package's tools
(CPU).

The tools are config surgery, checkpoint selection, paired statistics
and a verdict around ``DaggerTrainer.train`` / ``.eval``, which the
trainer and evaluator tests already hold against JAX. Here each package's
trainer is replaced by the same deterministic stub: ``train`` writes the
checkpoint files a run would and returns fixed losses; ``eval`` records
its config and returns metrics (and writes per-episode metrics) drawn
from a seed of the checkpoint's name, split, episode count and stop
threshold. Held, tool by tool, against the JAX tool run the same way:
  * ``learning_check`` (one and two stages), ``resume_judge``,
    ``judge_finish``, ``eval_thresholds``, ``sweep_stage1`` and
    ``diag_stage2_eval``: the same evals in the same order, their configs
    equal key by key (paths relative to each run's workdir), and the
    same summary and verdict;
  * ``learning_check`` rerun over the workdir of a run cut in stage 2
    ends where the uncut run does, and ``--pack`` / ``--unpack`` give back each
    checkpoint bit for bit from a fraction of its bytes;
  * ``parse_log`` equals JAX's on all four committed logs (JAX's epoch
    pattern starts at ``action_loss=``, so on the port's log it drops
    the ``loss`` the port prints first), and ``verdict`` reproduces each
    log's own ``LEARNING CHECK:`` line;
  * the port's fixture files equal ``build_fixtures``' after
    decoding, both packages read the rehearsal's ``LR: 0.001`` as the
    same float (JAX's tool writes ``1e-3``, a string to PyYAML), and one
    rehearsal of the four CLI runs on the CPU writes every artifact.
"""
import contextlib
import glob
import gzip
import io
import json
import os
import re
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import tools.diag_stage2_eval as jdiag_stage2
import tools.eval_thresholds as jeval_thresholds
import tools.judge_finish as jjudge_finish
import tools.learning_check as jlearning_check
import tools.resume_judge as jresume_judge
import tools.sweep_stage1 as jsweep_stage1
from tests.test_real_data_formats import build_fixtures as jbuild_fixtures
from ws_mgmap_tpu.train import trainer as jtrainer_mod
from ws_mgmap_tpu_torch import run as port_run
from ws_mgmap_tpu_torch.tools import (cli_rehearsal, diag_stage2_eval,
                                      eval_thresholds, judge_finish,
                                      learning_check, real_format_fixtures,
                                      resume_judge, sweep_stage1)
from ws_mgmap_tpu_torch.train import trainer as trainer_mod
from ws_mgmap_tpu_torch.utils import config as port_config

ROOT = Path(__file__).resolve().parents[1]
LOGS = sorted((ROOT / "logs").glob("*.log"))
# the logs of checks that reached their verdict (a cut run's log has none)
VERDICT_LOGS = [p for p in LOGS
                if re.search("^LEARNING CHECK:", p.read_text(), re.M)]
METRICS = ("distance_to_goal", "success", "spl", "ndtw", "path_length",
           "oracle_success", "oracle_navigation_error", "oracle_spl",
           "steps_taken", "sdtw")
TRAIN_METRICS = {"loss": 0.1, "action_loss": 0.03, "aux_loss": 0.07,
                 "prediction_monitor": 0.9, "contrastive_monitor": 0.01,
                 "progress_monitor": 0.02}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Stub:
    """The trainer of both packages, for these tests. ``calls`` holds
    (method, workdir-relative config) in order; ``cut_at`` makes the
    n-th ``train`` raise (a run cut there)."""

    calls: list = []
    workdir = ""
    cut_at = None

    def __init__(self, config, *args, **kwargs):
        self.config = config

    def _tree(self):
        text = json.dumps(self.config.to_dict(), sort_keys=True)
        return json.loads(text.replace(Stub.workdir, "<W>"))

    def train(self):
        Stub.calls.append(("train", self._tree()))
        if Stub.cut_at is not None and sum(
                c[0] == "train" for c in Stub.calls) == Stub.cut_at:
            raise KeyboardInterrupt("cut")
        cfg = self.config
        os.makedirs(cfg.CHECKPOINT_FOLDER, exist_ok=True)
        n = cfg.DAGGER.ITERATIONS * cfg.DAGGER.EPOCHS
        for i in range(n):
            path = os.path.join(cfg.CHECKPOINT_FOLDER, f"ckpt.{i}.pth")
            with open(path, "w") as f:
                f.write(str(i))
            os.utime(path, (1e9 + i, 1e9 + i))  # latest_checkpoint: mtime
        return dict(TRAIN_METRICS)

    def eval(self, *args, **kwargs):
        Stub.calls.append(("eval", self._tree()))
        cfg = self.config
        ck = os.path.basename(str(cfg.EVAL_CKPT_PATH_DIR or ""))
        if getattr(cfg, "random_agent", False):
            ck = "random"
        key = (f"{ck}|{cfg.EVAL.SPLIT}|{cfg.EVAL.EPISODE_COUNT}|"
               f"{cfg.STOP_CONDITION.PROG_THRESHOLD}")
        rng = np.random.RandomState(zlib.crc32(key.encode()))
        each = {}
        for i in range(cfg.EVAL.EPISODE_COUNT):
            m = {k: float(rng.rand() * 4) for k in METRICS}
            m["success"] = float(rng.rand() < 0.5)
            each[str(i)] = m
        agg = {k: float(np.mean([e[k] for e in each.values()]))
               for k in METRICS}
        metric_dir = getattr(cfg, "METRIC_DIR", None)
        if metric_dir:
            os.makedirs(metric_dir, exist_ok=True)
            with open(os.path.join(
                    metric_dir, f"each_stat_ckpt_0_{cfg.EVAL.SPLIT}.json"),
                    "w") as f:
                json.dump(each, f)
        return agg


@pytest.fixture()
def stub(monkeypatch):
    monkeypatch.setattr(jtrainer_mod, "DaggerTrainer", Stub)
    monkeypatch.setattr(trainer_mod, "DaggerTrainer", Stub)
    monkeypatch.setenv("WS_MGMAP_PLATFORM", "cpu")
    # both learning checks tee stdout / stderr: restore them afterwards
    monkeypatch.setattr(sys, "stdout", sys.stdout)
    monkeypatch.setattr(sys, "stderr", sys.stderr)
    Stub.calls, Stub.cut_at = [], None
    return Stub


def _main(module, argv, workdir):
    """Run a tool's ``main`` with ``argv`` in ``workdir``; returns (exit
    code, what it printed, the stub's calls)."""
    Stub.calls, Stub.workdir = [], str(workdir)
    out = io.StringIO()
    old = sys.argv
    sys.argv = [module.__name__] + [str(a) for a in argv]
    code = 0
    try:
        with contextlib.redirect_stdout(out):
            module.main()
    except SystemExit as e:
        code = e.code or 0
    finally:
        sys.argv = old
        sys.stdout, sys.stderr = sys.__stdout__, sys.__stderr__
    return code, out.getvalue(), list(Stub.calls)


def _summary(text):
    """The last JSON object and the verdict line of a tool's output."""
    path = Path(Stub.workdir) / "_out.txt"
    path.write_text(text)
    return resume_judge.read_summary(str(path))


def _norm(obj, workdir):
    return json.loads(json.dumps(obj, default=float).replace(
        str(workdir), "<W>"))


def _same_run(jres, pres):
    jcode, jout, jcalls = jres
    pcode, pout, pcalls = pres
    assert pcode == jcode
    assert [c[0] for c in pcalls] == [c[0] for c in jcalls]
    for (_, want), (_, got) in zip(jcalls, pcalls):
        assert got == want
    return jout, pout


# ---------------------------------------------------------------------------
# the learning check and its resume tools
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("two_stage", [False, True], ids=["stage1", "twostage"])
def test_learning_check_equals_jax(stub, tmp_path, monkeypatch, two_stage):
    args = ["--seed", "7", "--episodes", "96", "--prog-threshold", "0.4"]
    args += ["--two-stage"] if two_stage else []
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    monkeypatch.setattr(jlearning_check.tempfile, "mkdtemp",
                        lambda prefix="": str(tmp_path / "j"))
    jres = _main(jlearning_check, args + ["--log", tmp_path / "j.log"],
                 tmp_path / "j")
    pres = _main(learning_check, args + ["--log", tmp_path / "p.log",
                                         "--workdir", tmp_path / "p"],
                 tmp_path / "p")
    _same_run(jres, pres)
    want, want_ok = resume_judge.read_summary(str(tmp_path / "j.log"))
    got, got_ok = resume_judge.read_summary(str(tmp_path / "p.log"))
    assert _norm(got, tmp_path / "p") == _norm(want, tmp_path / "j")
    assert got_ok == want_ok
    assert learning_check.verdict(got, two_stage) == got_ok
    progress = json.loads((tmp_path / "p" / "progress.json").read_text())
    assert progress["train_final"] == TRAIN_METRICS


def test_learning_check_resumes_a_cut_run(stub, tmp_path):
    args = ["--two-stage", "--seed", "7", "--episodes", "96",
            "--workdir", tmp_path / "w", "--log", tmp_path / "w.log"]
    whole = _main(learning_check, args[:5] + ["--workdir", tmp_path / "x",
                                              "--log", tmp_path / "x.log"],
                  tmp_path / "x")
    Stub.cut_at = 2  # stage 2's training
    with pytest.raises(KeyboardInterrupt):
        _main(learning_check, args, tmp_path / "w")
    Stub.cut_at = None
    done = json.loads((tmp_path / "w" / "progress.json").read_text())
    assert set(done) == {"eval_untrained", "stage1_ckpt", "train_final",
                         "eval_trained"}
    resumed = _main(learning_check, args, tmp_path / "w")
    # the resumed run trains stage 2 and evaluates from there on, alone
    assert [c[0] for c in resumed[2]] == [c[0] for c in whole[2]][3:]
    assert [c[1] for c in resumed[2]] == [c[1] for c in whole[2]][3:]
    assert resumed[0] == whole[0]
    want, _ = resume_judge.read_summary(str(tmp_path / "x.log"))
    got, _ = resume_judge.read_summary(str(tmp_path / "w.log"))
    assert got == want
    log = (tmp_path / "w.log").read_text()
    assert log.count("[learning_check] logging to") == 2  # appended


def test_pack_unpack_round_trip(tmp_path, monkeypatch):
    """A packed checkpoint keeps what differs from the seeded initial
    policy; unpacked, it is the checkpoint again, bit for bit."""
    from ws_mgmap_tpu_torch.train import checkpoint as ckpt_lib

    monkeypatch.setenv("WS_MGMAP_PLATFORM", "cpu")
    w = tmp_path / "w"
    cfg = learning_check.apply_overrides(
        learning_check.tiny_config(str(w), 96, 10), 7, 0.4)
    policy = trainer_mod.DaggerTrainer(cfg, env_workers=False,
                                       device="cpu").init_policy()
    with torch.no_grad():
        for name, p in policy.named_parameters():
            if name.startswith("net.state_encoder"):
                p.add_(0.5)
    ckpt_lib.save_checkpoint(str(w / "ckpt" / "ckpt.9.pth"), policy, cfg)
    progress = learning_check.Progress(str(w))
    progress.record("stage1_ckpt", "ckpt.9.pth")
    progress.record("train_final", TRAIN_METRICS)
    learning_check.pack(str(w), str(tmp_path / "pk"), cfg)
    packed = tmp_path / "pk" / "ckpt" / "ckpt.9.pth"
    assert packed.stat().st_size < 0.5 * (w / "ckpt" / "ckpt.9.pth").stat().st_size
    learning_check.unpack(str(tmp_path / "pk"), str(tmp_path / "u"), cfg)
    a = torch.load(w / "ckpt" / "ckpt.9.pth", weights_only=False)
    b = torch.load(tmp_path / "u" / "ckpt" / "ckpt.9.pth", weights_only=False)
    assert list(a["state_dict"]) == list(b["state_dict"])
    for k, v in a["state_dict"].items():
        assert torch.equal(v, b["state_dict"][k]), k
    assert b["config"] == a["config"]
    assert json.loads((tmp_path / "u" / "progress.json").read_text()) == \
        progress.done


def _judge_workdir(root, with_s1_judge):
    for d, name in (("ckpt", "ckpt.9.pth"), ("ckpt_da", "ckpt.7.pth")):
        (root / d).mkdir(parents=True)
        (root / d / name).write_text("ckpt")
    if with_s1_judge:
        cfg = learning_check.tiny_config(str(root), 96, 10)
        Stub.workdir = str(root)
        Stub(learning_check.eval_config(
            cfg, str(root / "ckpt" / "ckpt.9.pth"),
            str(root / "judge_s1"))).eval()


@pytest.mark.parametrize("tool", ["resume_judge", "judge_finish"])
@pytest.mark.parametrize("log", ["learncheck_seed7_ep96_twostage.log",
                                 "torch_learncheck_seed0_stage1.log"])
def test_judge_tools_equal_jax(stub, tmp_path, tool, log):
    jtool, ptool = {"resume_judge": (jresume_judge, resume_judge),
                    "judge_finish": (jjudge_finish, judge_finish)}[tool]
    if tool == "resume_judge" and log.startswith("torch_"):
        # a stage-1 log: splice in a stage-1 judge eval line to resume from
        text = (ROOT / "logs" / log).read_text().replace(
            "LEARNING CHECK: PASS", "")
        text += ("[trainer] evaluating /x/ckpt/ckpt.9.pth\n"
                 "[trainer] [eval] 60 episodes: " + ", ".join(
                     f"{k}=0.500" for k in METRICS) + "\n")
    else:
        text = (ROOT / "logs" / log).read_text()
    results = {}
    for side, module in (("j", jtool), ("p", ptool)):
        root = tmp_path / side
        _judge_workdir(root, with_s1_judge=tool == "resume_judge")
        (tmp_path / f"{side}.log").write_text(text)
        args = ["--tmp", root, "--seed", "7", "--episodes", "96",
                "--best-ckpt", "ckpt.7.pth", "--log", tmp_path / f"{side}.log",
                "--prog-threshold", "0.4"]
        results[side] = _main(module, args + (["--in-process"]
                                              if side == "p" else []), root)
    _same_run(results["j"], results["p"])
    if tool == "resume_judge":  # JAX's prints; the port's appends to the log
        Stub.workdir = str(tmp_path / "j")
        want, want_ok = _summary(results["j"][1])
    else:
        want, want_ok = resume_judge.read_summary(str(tmp_path / "j.log"))
    got, got_ok = resume_judge.read_summary(str(tmp_path / "p.log"))
    assert got_ok == want_ok == learning_check.verdict(got, True)
    if log.startswith("torch_"):  # JAX's parse_log misses the port's loss
        assert got["train_final"].pop("loss") == 0.1626
    assert _norm(got, tmp_path / "p") == _norm(want, tmp_path / "j")


def test_eval_thresholds_equals_jax(stub, tmp_path):
    args = ["--ckpt", "ckpt/ckpt.9.pth", "--seed", "7", "--episodes", "96",
            "--thresholds", "0.40,0.55", "--n", "6"]
    res = {}
    for side, module in (("j", jeval_thresholds), ("p", eval_thresholds)):
        (tmp_path / side).mkdir()
        res[side] = _main(module, ["--tmp", tmp_path / side] + args,
                          tmp_path / side)
    jout, pout = _same_run(res["j"], res["p"])
    assert len(res["j"][2]) == 2
    assert ([l for l in pout.splitlines() if l.startswith("[eval_th")]
            == [l for l in jout.splitlines() if l.startswith("[eval_th")])
    assert json.loads(pout.splitlines()[-1]) == json.loads(
        jout.splitlines()[-1])


def test_sweep_stage1_equals_jax(stub, tmp_path, monkeypatch):
    args = ["--seed", "7", "--episodes", "48", "--thresholds", "0.4,0.55",
            "--judge-n", "6", "--lr", "0.002"]
    (tmp_path / "j").mkdir()
    monkeypatch.setattr(jsweep_stage1.tempfile, "mkdtemp",
                        lambda prefix="": str(tmp_path / "j"))
    jres = _main(jsweep_stage1, args, tmp_path / "j")
    pres = _main(sweep_stage1, args + ["--workdir", tmp_path / "p"],
                 tmp_path / "p")
    jout, pout = _same_run(jres, pres)
    Stub.workdir = str(tmp_path / "j")
    want, _ = _summary(jout + "\nLEARNING CHECK: PASS\n")
    Stub.workdir = str(tmp_path / "p")
    got, _ = _summary(pout + "\nLEARNING CHECK: PASS\n")
    assert _norm(got, tmp_path / "p") == _norm(want, tmp_path / "j")


def test_diag_stage2_eval_equals_jax(stub, tmp_path):
    res = {}
    for side, module in (("j", jdiag_stage2), ("p", diag_stage2_eval)):
        root = tmp_path / side
        Stub.workdir = str(root)
        cfg = learning_check.tiny_config(str(root), 96, 10)
        Stub(learning_check.stage2_config(cfg, str(root), 96, "x")).train()
        Stub(cfg).train()
        res[side] = _main(module, [root, "--episodes", "6"], root)
    jout, pout = _same_run(res["j"], res["p"])
    assert len(res["j"][2]) == 4  # stage 1 and 3 DAgger iterations
    for tag in ("[diag]", "[paired]"):
        assert ([l for l in pout.splitlines() if l.startswith(tag)]
                == [l for l in jout.splitlines() if l.startswith(tag)])


# ---------------------------------------------------------------------------
# the committed logs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("log", LOGS, ids=[p.stem for p in LOGS])
def test_parse_log_equals_jax(log):
    jevals, jepochs = jresume_judge.parse_log(str(log))
    evals, epochs = resume_judge.parse_log(str(log))
    assert evals == jevals and evals
    assert [e[:2] for e in epochs] == [e[:2] for e in jepochs] and epochs
    port_log = re.search(r"batches in \S+s loss=", log.read_text())
    for (_, _, got), (_, _, want) in zip(epochs, jepochs):
        if port_log:
            assert "loss" in got and "loss" not in want
            got = {k: v for k, v in got.items() if k != "loss"}
        assert got == want


@pytest.mark.parametrize("log", VERDICT_LOGS,
                         ids=[p.stem for p in VERDICT_LOGS])
def test_verdict_reproduces_each_log(log):
    out, ok = resume_judge.read_summary(str(log))
    assert learning_check.verdict(out, "eval_stage2" in out) == ok


# ---------------------------------------------------------------------------
# the rehearsal
# ---------------------------------------------------------------------------
def _decode(root):
    files = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*"),
                                 recursive=True)):
        rel = os.path.relpath(path, root)
        if path.endswith(".json.gz"):
            with gzip.open(path, "rt") as f:
                files[rel] = json.load(f)
        elif path.endswith(".npy"):
            files[rel] = np.load(path).tolist()
    return files


@pytest.mark.parametrize("split,n", [("val_seen", 4), ("train", 3)])
def test_fixtures_equal_jax(tmp_path, split, n):
    want = jbuild_fixtures(str(tmp_path / "j"), split=split, n_eps=n)
    got = real_format_fixtures.build_fixtures(str(tmp_path / "p"),
                                              split=split, n_eps=n)
    np.testing.assert_array_equal(got, want)
    a, b = _decode(tmp_path / "j"), _decode(tmp_path / "p")
    assert a.keys() == b.keys() and len(a) == 3 + n
    assert a == b


def test_rehearsal_yaml_learning_rate(tmp_path):
    """JAX's tool writes ``LR: 1e-3``, which PyYAML (and so JAX's config)
    reads as the string "1e-3"; the port writes 0.001, read as that float
    by both packages, and its reader refuses ``1e-3``."""
    from ws_mgmap_tpu.config.default import get_config as jget_config
    from ws_mgmap_tpu_torch.config.default import get_config

    port_yaml = tmp_path / "p.yaml"
    port_yaml.write_text(cli_rehearsal.rehearsal_yaml(4, 10))
    jax_text = port_yaml.read_text().replace("ws_mgmap_tpu_torch/",
                                             "ws_mgmap_tpu/")
    jax_yaml = tmp_path / "j.yaml"
    jax_yaml.write_text(jax_text)
    jax_tool_yaml = tmp_path / "j_tool.yaml"
    jax_tool_yaml.write_text(jax_text.replace("0.001", "1e-3"))
    assert jget_config(str(jax_tool_yaml)).DAGGER.LR == "1e-3"
    assert get_config(str(port_yaml)).DAGGER.LR == \
        jget_config(str(jax_yaml)).DAGGER.LR == 0.001
    with pytest.raises(port_config.YAMLSubsetError):
        get_config(str(jax_tool_yaml))


class InProcess(trainer_mod.DaggerTrainer):
    """The CLI's trainer with its envs in process and no TensorBoard."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, env_workers=False, **kwargs)

    def _tb(self):
        return None


def test_rehearsal_on_cpu(tmp_path, monkeypatch):
    """The four CLI runs over the real-format tree at the JAX tool's
    reduced model, its depth cut to 2 episodes a split and 30 steps."""
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("WS_MGMAP_PLATFORM", "cpu")
    monkeypatch.setattr(trainer_mod, "DaggerTrainer", InProcess)
    data = tmp_path / "data"
    vocab = cli_rehearsal.build_tree(str(data), 2)

    def run(run_type, cfg_yaml, model_dir, opts):
        port_run.main(["--run-type", run_type, "-c", cfg_yaml,
                       "-e", model_dir] + opts)

    out = cli_rehearsal.rehearse(
        str(tmp_path), run, cli_rehearsal.rehearsal_yaml(2, len(vocab)),
        cli_rehearsal.rehearsal_yaml(2, len(vocab), iterations=2, p=0.5),
        cli_rehearsal.data_opts(str(data), max_steps=30), log=lambda m: None)
    assert [os.path.basename(p) for p in out["stage1_ckpts"]] == \
        ["ckpt.0.pth", "ckpt.1.pth"]
    assert len(out["stage2_ckpts"]) == 4
    assert out["predictions"] == 2
    assert set(out["metrics"]) >= {"success", "spl", "ndtw"}
