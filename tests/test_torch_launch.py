"""The gang launcher (``bigdl_tpu_torch.tools.launch``) and the backend
rule (``utils.engine.choose_backend``), on the CPU: the TransformerLM
train CLI launched on 2 gloo ranks with ``--sp ring --spSize 2`` ends on
the loss of a one-rank dense run within 1e-5; a worker that exits 3
fails the gang with a typed ``ProcExit``; the wall limit kills a hung
gang; each worker sees the rendezvous environment; the flags that wait
for the elastic layer raise."""
import os
import re
import sys

import pytest
import torch

from bigdl_tpu_torch.models.transformer import train as transformer_train
from bigdl_tpu_torch.tools import launch
from bigdl_tpu_torch.utils import engine

TRAIN = transformer_train.__file__
SMALL = ["--synthetic", "3000", "--device", "cpu", "--vocabSize", "64",
         "--seqLen", "32", "--hiddenSize", "32", "--heads", "4",
         "--layers", "2", "-b", "4", "--maxIterations", "3"]


def _final_loss(result, rank=0):
    rep = next(r for r in result.reports if r.rank == rank)
    for line in rep.lines:
        m = re.search(r"^mesh: .* backend: (\w+) rank: \d+ loss: (\S+)$",
                      line.strip())
        if m:
            return m.group(1), float(m.group(2))
    raise AssertionError("no mesh line:\n" + rep.output_tail)


def test_sp_ring_gang_matches_the_dense_run():
    sp = launch.run_gang(launch.build_args(
        TRAIN, SMALL + ["--sp", "ring", "--spSize", "2"], nproc=2,
        timeout=240, echo=False))
    assert sp.ok, [r.output_tail for r in sp.failed()]
    dense = launch.run_gang(launch.build_args(TRAIN, SMALL, nproc=1,
                                              timeout=240, echo=False))
    assert dense.ok, [r.output_tail for r in dense.failed()]
    backend, want = _final_loss(dense)
    assert backend == "gloo"
    for rank in (0, 1):
        backend, got = _final_loss(sp, rank)
        assert backend == "gloo"
        assert got == pytest.approx(want, abs=1e-5)
    assert all("final loss:" in "".join(r.lines) for r in sp.reports)


def test_a_failing_worker_fails_the_gang_with_a_typed_exit(tmp_path):
    script = tmp_path / "w.py"
    script.write_text(
        "import os, sys\n"
        "keys = ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK',\n"
        "        'LOCAL_RANK', 'LOCAL_WORLD_SIZE', 'BIGDL_RESTART_ATTEMPT')\n"
        "print(' '.join(k + '=' + os.environ[k] for k in keys))\n"
        "sys.exit(3 if os.environ['RANK'] == '1' else 0)\n")
    res = launch.run_gang(launch.build_args(str(script), nproc=2,
                                            timeout=60, echo=False))
    assert not res.ok
    assert isinstance(res.culprit, launch.ProcExit)
    assert (res.culprit.rank, res.culprit.returncode,
            res.culprit.kind) == (1, 3, "runtime")
    env0 = dict(kv.split("=") for kv in res.reports[0].lines[0].split())
    assert env0["WORLD_SIZE"] == "2" and env0["RANK"] == "0"
    assert env0["LOCAL_WORLD_SIZE"] == "2"
    assert env0["BIGDL_RESTART_ATTEMPT"] == "0"
    with pytest.raises(SystemExit, match="worker 1 failed rc=3"):
        launch.main(["--nproc", "2", "--timeout", "60", str(script)])


def test_the_wall_limit_kills_a_hung_gang(tmp_path):
    script = tmp_path / "hang.py"
    script.write_text("import time\ntime.sleep(120)\n")
    res = launch.run_gang(launch.build_args(str(script), nproc=2,
                                            timeout=2, echo=False))
    assert not res.ok
    assert {r.kind for r in res.reports} == {"timeout"}


def test_a_gang_restart_reruns_every_worker(tmp_path):
    script = tmp_path / "flaky.py"
    script.write_text(
        "import os, sys\n"
        "sys.exit(5 if os.environ['BIGDL_RESTART_ATTEMPT'] == '0'\n"
        "         and os.environ['RANK'] == '0' else 0)\n")
    res = launch.run_gang(launch.build_args(str(script), nproc=2,
                                            max_restarts=1, timeout=60,
                                            echo=False))
    assert res.ok and res.restarts == 1
    assert all(r.attempt == 1 for r in res.reports)


def test_flags_that_wait_for_the_elastic_layer_raise():
    with pytest.raises(NotImplementedError, match="item 12"):
        launch.build_args("x.py", ship_telemetry="/tmp/t")
    with pytest.raises(NotImplementedError, match="a rank is a process"):
        launch.build_args("x.py", cpu_devices=4)
    with pytest.raises(NotImplementedError, match="item 12"):
        launch.main(["--ship-telemetry", "d", "x.py"])


def test_the_backend_rule(monkeypatch):
    assert engine.choose_backend(1) == ("nccl" if torch.cuda.is_available()
                                        else "gloo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert engine.choose_backend(1) == "nccl"      # one rank, one card
    assert engine.choose_backend(2) == "gloo"      # two ranks share it
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert engine.choose_backend() == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert engine.choose_backend() == "nccl"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert engine.choose_backend() == "gloo"       # the CPU


def test_the_rank_device(monkeypatch):
    assert engine.rank_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert engine.rank_device() == torch.device("cuda", 1)
    assert engine.rank_device("cuda:0") == torch.device("cuda", 0)
