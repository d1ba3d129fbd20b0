"""The port's umbrella command line (``python -m
prosody_control_french_tts_tpu_torch <command>``) against the JAX
package's, on the CPU.

``run``, ``sync``, ``legacy`` and ``abtest`` run for real on a tiny config
(the voice of ``tests/test_pipeline_e2e.py`` with precomputed TextGrids, and
the legacy chain's voice of ``tests/test_torch_legacy.py``), the port with
``--device cpu``: the same artifacts as the JAX CLI's, byte-equal where the
pipeline tests hold them so, and the legacy CSVs at the legacy test's
tolerances. ``analyze`` and ``corpus`` print the same output. The training,
evaluation and viewer commands run with the functions they call replaced by
recorders on both sides: every argument reaches the same parameter, with
the same defaults, and ``--device`` (default ``cuda``) reaches the port's.
"""

import contextlib
import io
import json
import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from prosody_control_french_tts_tpu.__main__ import main as jmain
from prosody_control_french_tts_tpu_torch.__main__ import main as tmain
from prosody_control_french_tts_tpu_torch.utils import wavio as twav
from test_torch_legacy import ADJUSTMENT_COLUMNS, PITCH_COLUMNS, build_legacy_voice
from test_torch_legacy import NAME as LEGACY
from test_torch_pipeline import CONFIG, NAME, RESULTS, TEXT_ARTIFACTS, build_voice

ROOT = Path(__file__).resolve().parent.parent
AB = {"output_dir": "Out/AB_test", "num_pairs": 2, "target_duration_s": 4, "margin_s": 2}


@contextlib.contextmanager
def _quiet_logging():
    """``run`` installs the pipeline's log handlers on the root logger:
    put the test's back afterwards."""
    root = logging.getLogger()
    saved = (root.handlers[:], root.level)
    try:
        yield
    finally:
        for h in root.handlers:
            if h not in saved[0]:
                h.close()
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])


def _call(main, argv) -> tuple:
    out = io.StringIO()
    with _quiet_logging(), contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Per side: (base, {command: (rc, stdout)})."""
    runs = {}
    for kind, main, dev in (("jax", jmain, []), ("torch", tmain, ["--device", "cpu"])):
        base = tmp_path_factory.mktemp(f"cli_{kind}")
        build_voice(base)
        build_legacy_voice(base)
        cfg = base / "config.yaml"
        cfg.write_text(yaml.dump(dict(CONFIG, ab_test=AB)), encoding="utf-8")
        out = {
            "run": _call(main, ["run", "--config", str(cfg)] + dev),
            "sync": _call(main, ["sync", "--config", str(cfg), "--voice", NAME]),
            "legacy": _call(main, ["legacy", "--config", str(cfg), "--voice", LEGACY] + dev),
            "abtest": _call(main, ["abtest", "--config", str(cfg)]),
        }
        runs[kind] = (base, out)
    return runs


@pytest.mark.parametrize("command", ["run", "sync", "legacy", "abtest"])
def test_commands_print_the_same(cli_runs, command):
    (jbase, jout), (tbase, tout) = cli_runs["jax"], cli_runs["torch"]
    (jrc, jtext), (trc, ttext) = jout[command], tout[command]
    assert trc == jrc and trc in (None, 0)
    assert ttext.replace(str(tbase), "BASE") == jtext.replace(str(jbase), "BASE")


@pytest.mark.parametrize("name", TEXT_ARTIFACTS)
def test_run_artifacts_byte_equal(cli_runs, name):
    jbase, tbase = cli_runs["jax"][0], cli_runs["torch"][0]
    want = (jbase / RESULTS / name).read_bytes()
    assert (tbase / RESULTS / name).read_bytes() == want


@pytest.mark.parametrize("where", ["Out/results/testvoice/synchronized", "Out/AB_test"])
def test_sync_and_abtest_outputs_equal(cli_runs, where):
    """Every file the command wrote: the same names, texts byte-equal, wavs
    sample-equal."""
    jdir, tdir = cli_runs["jax"][0] / where, cli_runs["torch"][0] / where
    files = sorted(p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(tdir) for p in tdir.rglob("*") if p.is_file())
    for rel in files:
        if rel.suffix == ".wav":
            a, b = twav.read_wav(jdir / rel), twav.read_wav(tdir / rel)
            assert a.rate == b.rate and np.array_equal(a.samples, b.samples), rel
        else:
            assert (tdir / rel).read_bytes() == (jdir / rel).read_bytes(), rel


@pytest.mark.parametrize("name", ["BDD2.csv", "BDD3.csv", "BDD4.csv", "BDD_ssml.csv"])
def test_legacy_outputs_match(cli_runs, name):
    import csv

    (jbase, _), (tbase, _) = cli_runs["jax"], cli_runs["torch"]
    rel = Path("Out/results") / LEGACY / "legacy" / name
    with open(jbase / rel, newline="", encoding="utf-8") as f:
        want = list(csv.DictReader(f))
    with open(tbase / rel, newline="", encoding="utf-8") as f:
        got = list(csv.DictReader(f))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for col in w:
            if col in PITCH_COLUMNS:
                assert float(g[col]) == pytest.approx(float(w[col]), rel=1e-3, abs=0), col
            elif col in ADJUSTMENT_COLUMNS:
                assert abs(float(g[col]) - float(w[col])) <= 1e-3, col
            elif col == "ssml":
                assert g[col].split("pitch='")[0] == w[col].split("pitch='")[0]
            else:
                assert g[col].replace(str(tbase), "") == w[col].replace(str(jbase), ""), col
    assert (tbase / rel.parent / "OUT.wav").exists()


def _corpus(root: Path) -> Path:
    from prosody_control_french_tts_tpu_torch.utils.synth import synth_voice

    seg_files, _, _ = synth_voice(root / "synth", seed=2, n_segments=2, seconds=(1.0, 1.5))
    d = root / "corpus"
    d.mkdir()
    for i, (p, text) in enumerate(zip(seg_files, ["Bonjour, le monde.", "Oui ! Quelle belle journée ; merci."])):
        for spk in ("a", "b"):
            (d / f"{spk}__segment_ph{i}.wav").write_bytes(p.read_bytes())
            (d / f"{spk}__segment_ph{i}.txt").write_text(text, encoding="utf-8")
    return d


def test_analyze_prints_the_same_json(tmp_path):
    d = _corpus(tmp_path)
    (jrc, jtext), (trc, ttext) = _call(jmain, ["analyze", str(d)]), _call(tmain, ["analyze", str(d)])
    assert jrc == trc == 0 and ttext == jtext
    assert json.loads(ttext)["files"] == 4


def test_corpus_builds_the_same_pairs(tmp_path):
    printed = []
    for kind, main in (("jax", jmain), ("torch", tmain)):
        data = tmp_path / kind / "Data"
        for voice in ("v1", "v2"):
            (data / voice / "audio").mkdir(parents=True)
            (data / voice / "transcription").mkdir(parents=True)
            for i in (1, 2):
                twav.write_wav(data / voice / "audio" / f"segment_ph{i}.wav", np.full(800, 0.1 * i), 8000)
                (data / voice / "transcription" / f"segment_ph{i}.txt").write_text(f"phrase {i}.", encoding="utf-8")
        rc, text = _call(main, ["corpus", str(data), str(tmp_path / kind / "corpus")])
        assert rc == 0
        printed.append(text)
    assert printed[0] == printed[1] == "4 pairs\n"
    jfiles = sorted(p.relative_to(tmp_path / "jax" / "corpus") for p in (tmp_path / "jax" / "corpus").rglob("*") if p.is_file())
    assert jfiles == sorted(p.relative_to(tmp_path / "torch" / "corpus") for p in (tmp_path / "torch" / "corpus").rglob("*") if p.is_file())


# ---------------------------------------------------------------------------
# the commands that train, evaluate or serve: recorders on both sides
# ---------------------------------------------------------------------------


class Recorder:
    def __init__(self, result):
        self.result, self.calls = result, []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.result


# command → (module path under the package, function, its stand-in's return, argv after the command)
RECIPES = {
    "train-ctc": ("align.train_ctc", "train_ctc_aligner", (None, [0.5]), ["--corpus", "C", "--out", "o.npz", "--epochs", "3"]),
    "pretrain-ctc": ("align.pretrain_ctc", "pretrain", (None, 7.0), ["--sentences", "12", "--epochs", "2", "--batch", "4"]),
    "pretrain-whisper": ("align.pretrain_whisper", "pretrain", (None, 30.0, 0.9),
                         ["--out", "w", "--sentences", "8", "--epochs", "1", "--batch", "2", "--domain", "synth"]),
    "pretrain-masknet": ("audio.separate", "pretrain_masknet", (None, 6.0), ["--mixtures", "4", "--epochs", "1", "--plain"]),
    "train-break": ("models.experiment", "run_break_experiment", {}, ["--bdd", "b.json", "--runs", "2", "--epochs", "1", "--tiny"]),
    "train-bilstm": ("models.experiment", "run_bilstm_experiment", [], ["--bdd", "b.json", "--out", "o", "--epochs", "2"]),
    "cascade": ("models.experiment", "run_cascade_experiment", {}, ["--bdd", "b.json", "--epochs", "1"]),
    "fewshot": ("models.experiment", "run_fewshot_experiment", {}, ["--bdd", "b.json"]),
    "eval": ("eval.evaluate_voice", "evaluate_all", {}, []),
    "agreement": ("eval.real_audio_agreement", "corpus_agreement_report", {"summary": {}}, ["--corpus", "CORPUS", "--out", "-"]),
}
HOST_ONLY = {"fewshot"}


def _normalise(value, pkg_root: Path):
    """Paths inside either package compare relative to the package."""
    if isinstance(value, (str, Path)) and str(value).startswith(str(pkg_root)):
        return str(Path(value).relative_to(pkg_root))
    if isinstance(value, (list, tuple)):
        return type(value)(_normalise(v, pkg_root) for v in value)
    return value


@pytest.mark.parametrize("command", sorted(RECIPES))
def test_arguments_reach_their_parameters(command, tmp_path, monkeypatch):
    import importlib

    mod_path, fn, result, argv = RECIPES[command]
    if command == "eval":
        (tmp_path / "config.yaml").write_text(yaml.dump({"out_dir": "O", "data_dir": "D"}), encoding="utf-8")
        argv = ["--config", str(tmp_path / "config.yaml")]
    seen = {}
    for kind, main in (("jax", jmain), ("torch", tmain)):
        pkg = "prosody_control_french_tts_tpu" + ("_torch" if kind == "torch" else "")
        rec = Recorder(result)
        monkeypatch.setattr(importlib.import_module(f"{pkg}.{mod_path}"), fn, rec)
        extra = ["--device", "cpu"] if kind == "torch" and command not in HOST_ONLY else []
        rc, _ = _call(main, [command] + argv + extra)
        assert rc == 0 and len(rec.calls) == 1
        args, kwargs = rec.calls[0]
        root = ROOT / pkg
        seen[kind] = (_normalise(args, root), {k: _normalise(v, root) for k, v in kwargs.items()})
    targs, tkw = seen["torch"]
    if command not in HOST_ONLY:
        assert tkw.pop("device") == torch.device("cpu")
    assert (targs, tkw) == seen["jax"]


def test_pretrain_pos_arguments(tmp_path, monkeypatch):
    from prosody_control_french_tts_tpu_torch.models import pos_data, pos_tagger

    treebank, train, save = Recorder(["s"]), Recorder(({"w": 1}, "feat", "cfg")), Recorder(None)
    monkeypatch.setattr(pos_data, "generate_treebank", treebank)
    monkeypatch.setattr(pos_tagger, "train_pos_tagger", train)
    monkeypatch.setattr(pos_tagger, "save_tagger", save)
    cpu = torch.device("cpu")
    assert _call(tmain, ["pretrain-pos", "--sentences", "40", "--steps", "3", "--out", "p.npz", "--device", "cpu"])[0] == 0
    assert treebank.calls == [((40,), {"seed": 0})]
    assert train.calls == [((["s"],), {"steps": 3, "device": cpu})]
    assert save.calls == [(({"w": 1}, "feat", "cfg", "p.npz"), {})]
    _call(tmain, ["pretrain-pos", "--device", "cpu"])
    assert treebank.calls[-1] == ((16000,), {"seed": 0}) and train.calls[-1][1] == {"steps": 900, "device": cpu}
    assert save.calls[-1][0][3] == str(pos_tagger.PACKAGED_WEIGHTS)


def test_viz_command_serves_on_the_asked_device(tmp_path, monkeypatch):
    from prosody_control_french_tts_tpu_torch.viz import server

    served = []

    class FakeServer:
        def shutdown(self):
            served.append("shutdown")

        def server_close(self):
            served.append("closed")

    class Interrupt:
        def wait(self):
            raise KeyboardInterrupt

    monkeypatch.setattr(server, "serve", lambda svc, port, preload: served.append((svc, port, preload)) or FakeServer())
    monkeypatch.setattr(server.threading, "Event", Interrupt)
    (tmp_path / "n").mkdir()
    rc, _ = _call(tmain, ["viz", "--natural", str(tmp_path / "n"), "--port", "0", "--no-preload", "--device", "cpu"])
    svc, port, preload = served[0]
    assert rc == 0 and svc.device.type == "cpu" and list(svc.dirs) == ["natural"] and (port, preload) == (0, False)
    assert served[1:] == ["shutdown", "closed"]


@pytest.mark.parametrize("argv", [
    ["legacy", "--config", "CFG", "--voice", LEGACY], ["run", "--config", "CFG"],
    ["viz", "--natural", "."], ["eval", "--config", "CFG"], ["pretrain-ctc", "--out", "x.npz"], ["train-ctc", "--corpus", "."],
    ["pretrain-whisper", "--out", "w"], ["pretrain-masknet", "--out", "m.npz"], ["pretrain-pos", "--out", "p.npz"],
    ["train-break", "--bdd", "b.json"], ["train-bilstm", "--bdd", "b.json"], ["cascade", "--bdd", "b.json"],
    ["agreement", "--corpus", "."],
])
def test_without_a_card_cuda_raises(tmp_path, argv):
    """The default device on a host with no card raises, through every
    layer of the command line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid here")
    build_voice(tmp_path)
    build_legacy_voice(tmp_path)
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.dump(CONFIG), encoding="utf-8")
    with pytest.raises(RuntimeError, match="CUDA"):
        _call(tmain, [a.replace("CFG", str(cfg)) for a in argv])
    assert not (tmp_path / "Out").exists()


def test_bench_and_unknown_commands_return_1(capsys):
    assert tmain(["bench"]) == 1
    assert "no benchmark" in capsys.readouterr().err
    assert tmain(["nonsense"]) == 1
    assert "unknown command 'nonsense'" in capsys.readouterr().out
    assert tmain([]) == 1
    assert "pretrain-masknet" in capsys.readouterr().out


def test_every_jax_command_exists():
    """Each command the JAX CLI dispatches has a branch here: ``--help``
    reaches its parser (exit 0); an unknown one returns 1."""
    import re

    src = (ROOT / "prosody_control_french_tts_tpu" / "__main__.py").read_text(encoding="utf-8")
    commands = set(re.findall(r'cmd == "([a-z-]+)"', src))
    for group in re.findall(r"cmd in \(([^)]*)\)", src):
        commands |= set(re.findall(r'"([a-z-]+)"', group))
    assert len(commands) == 19
    for cmd in sorted(commands - {"bench"}):
        with pytest.raises(SystemExit) as e, contextlib.redirect_stdout(io.StringIO()):
            tmain([cmd, "--help"])
        assert e.value.code == 0, cmd


def test_python_dash_m_imports_no_jax():
    """``python -m prosody_control_french_tts_tpu_torch <command> --help``
    for every command, in one fresh interpreter: no module of JAX or of
    the JAX package is loaded."""
    code = (
        "import contextlib, io, runpy, sys\n"
        "cmds = ['run', 'sync', 'legacy', 'abtest', 'viz', 'analyze', 'corpus', 'eval', 'train-break', 'train-bilstm',\n"
        "        'fewshot', 'cascade', 'train-ctc', 'pretrain-ctc', 'pretrain-whisper', 'pretrain-masknet', 'pretrain-pos',\n"
        "        'agreement']\n"
        "for c in cmds:\n"
        "    sys.argv = ['prosody_control_french_tts_tpu_torch', c, '--help']\n"
        "    try:\n"
        "        with contextlib.redirect_stdout(io.StringIO()):\n"
        "            runpy.run_module('prosody_control_french_tts_tpu_torch', run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert e.code == 0, (c, e.code)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'transformers'\n"
        "             or m == 'prosody_control_french_tts_tpu' or m.startswith('prosody_control_french_tts_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    res = subprocess.run([sys.executable, "-m", "prosody_control_french_tts_tpu_torch", "bench"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 1 and "no benchmark" in res.stderr
