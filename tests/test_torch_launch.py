"""The port's launcher and ``spawn`` (``paddle_tpu_torch.distributed``),
as ``tests/test_launch_spawn.py`` holds the JAX ones: the environment
protocol (the JAX names and torch's), failure propagation that stops
the peers, the log directory, the CLI, ``spawn`` by ``"module:function"``
and its re-raised failure, and a launched two-rank gloo job."""

import os
import subprocess
import sys
import textwrap
import time

import pytest

from paddle_tpu_torch.distributed.launch import launch, main
from paddle_tpu_torch.distributed.spawn_mod import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write(tmp_path, body):
    p = tmp_path / "worker.py"
    p.write_text(textwrap.dedent(body))
    return str(p)


def test_launch_sets_env_protocol(tmp_path):
    out = tmp_path / "out"
    out.mkdir()
    script = _write(tmp_path, f"""
        import os
        rank = os.environ["PADDLE_TRAINER_ID"]
        with open(r"{out}" + "/rank_" + rank, "w") as f:
            f.write(",".join(os.environ[k] for k in (
                "PADDLE_TRAINERS_NUM", "PADDLE_MASTER", "MASTER_PORT",
                "PADDLE_LOCAL_RANK", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE", "MASTER_ADDR")))
    """)
    assert launch(script, [], nproc_per_node=2, port=23456) == 0
    assert sorted(os.listdir(out)) == ["rank_0", "rank_1"]
    assert (out / "rank_1").read_text().split(",") == [
        "2", "127.0.0.1", "23456", "1", "1", "2", "1", "2", "127.0.0.1"]


def test_launch_propagates_failure_and_stops_peers(tmp_path):
    script = _write(tmp_path, """
        import os, sys, time
        if os.environ["PADDLE_TRAINER_ID"] == "1":
            sys.exit(7)
        time.sleep(30)          # would hang; must be terminated
    """)
    t0 = time.time()
    assert launch(script, [], nproc_per_node=2) == 7
    assert time.time() - t0 < 20, "peers not terminated on failure"


def test_launch_log_dir(tmp_path):
    script = _write(tmp_path, """
        import os
        print("hello from", os.environ["PADDLE_TRAINER_ID"])
    """)
    assert launch(script, [], nproc_per_node=2,
                  log_dir=str(tmp_path / "logs")) == 0
    assert sorted(os.listdir(tmp_path / "logs")) == ["workerlog.0",
                                                     "workerlog.1"]
    assert "hello from 0" in (tmp_path / "logs" / "workerlog.0").read_text()


def test_main_cli_args(tmp_path):
    assert main(["--nproc_per_node", "1", _write(tmp_path, "pass")]) == 0


def test_module_cli_runs_a_gloo_job(tmp_path):
    """``python -m paddle_tpu_torch.distributed.launch`` starts two ranks
    that join one gloo world through ``init_parallel_env`` and
    all-reduce."""
    script = _write(tmp_path, f"""
        import torch
        torch.set_num_threads(1)
        import paddle_tpu_torch.distributed as dist
        env = dist.init_parallel_env(backend="gloo")
        t = torch.tensor([float(env.rank + 1)])
        dist.all_reduce(t)
        with open(r"{tmp_path}/sum_" + str(env.rank), "w") as f:
            f.write(str(float(t)) + "," + env.backend)
    """)
    port = __import__("paddle_tpu_torch.distributed.parallel",
                      fromlist=["_free_port"])._free_port()
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--port", str(port),
         "--log_dir", str(tmp_path / "logs"), script],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert r.returncode == 0, (tmp_path / "logs" / "workerlog.0").read_text()
    for rank in (0, 1):
        assert (tmp_path / f"sum_{rank}").read_text() == "3.0,gloo"


def test_spawn_runs_workers_by_module_function(tmp_path):
    spawn("_torch_dist_workers:write_env", args=(str(tmp_path),), nprocs=2)
    assert sorted(os.listdir(tmp_path)) == ["env_0", "env_1"]
    fields = (tmp_path / "env_1").read_text().split(",")
    assert fields[:2] == ["1", "2"] and fields[4:] == ["1", "1", "2", "2"]


def test_spawn_raises_the_first_failure():
    with pytest.raises(RuntimeError, match="rank 1 gives up"):
        spawn("_torch_dist_workers:fail_on_rank_1", nprocs=2)
