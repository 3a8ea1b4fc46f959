"""The port's training entry point on the CPU: its ETL and
``workloads/playlist.train`` from TFRecords and from packed shards, the
CLI, a resume that equals the uninterrupted run, and a SIGTERM drill in
a subprocess.

Bars: the JAX package's own end-to-end test of ``train``
(``tests/test_playlist.py::test_playlist_train_and_eval_e2e``: eval
artist recall@10 > 0.2, train loss < 25) on a twin of its ``tiny_mpd``,
at ``n_model_shards=1`` (the sharded tables are not ported). The resumed
run equals the uninterrupted one bit for bit (the CPU's plain versions
are deterministic), given that a resumed run's input stream starts again
from its seed, as the reference's does.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _etl(tmp, pack=False):
    from tests.test_torch_data import write_mpd
    from esrecsys_tpu_torch.etl import playlists as etl

    pattern = write_mpd(os.path.join(tmp, "raw"), ragged=False)
    out = os.path.join(tmp, "training")
    etl.main(["--playlists", pattern, "--output", out, "--pack",
              str(pack), "--pack_max_next", "8"])
    return out


def _cfg(data, work_dir, **kw):
    from esrecsys_tpu_torch.workloads import playlist as tpl

    base = dict(
        train_pattern=f"{data}/*.tfrecord", test_pattern=f"{data}/*.tfrecord",
        all_tracks=f"{data}/all_tracks.json", dictionaries=data,
        work_dir=work_dir, feature_size=8, album_hash_buckets=16,
        num_artists=10, num_negatives=8, batch_size=4, max_next=8,
        learning_rate=0.1, max_steps=150, log_every_steps=50,
        eval_every_steps=75, eval_steps=8, eval_k=10, corpus_block=16)
    return tpl.PlaylistConfig(**{**base, **kw})


@pytest.fixture(scope="module")
def mpd(tmp_path_factory):
    return _etl(str(tmp_path_factory.mktemp("mpd")), pack=True)


def test_etl_and_train_meet_the_reference_bars(mpd, tmp_path):
    from esrecsys_tpu.train.export import load_model as jax_load_model
    from esrecsys_tpu_torch.train import Checkpointer
    from esrecsys_tpu_torch.workloads import playlist as tpl

    cfg = _cfg(mpd, str(tmp_path / "wd"), checkpoint_every_steps=100)
    result = tpl.train(cfg, device="cpu")
    assert result.steps_run == 150 and not result.preempted
    assert result.last_eval_metrics["eval_artist_recall"] > 0.2
    assert result.last_train_metrics["train_loss"] < 25.0
    assert Checkpointer(f"{cfg.work_dir}/checkpoints").all_steps() == [100,
                                                                       150]
    with open(f"{cfg.work_dir}/metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [50, 75, 100, 150, 150]
    with open(f"{cfg.work_dir}/artifacts.jsonl") as f:
        art = json.loads(f.readline())
    params, _, meta = jax_load_model(art["path"])  # the reference loads it
    assert meta == {"name": "playlist", "step": 150, "feature_size": 8,
                    "album_hash_buckets": 16, "num_artists": 10,
                    "valid_rows": {"album_embed": 16, "artist_embed": 10}}
    np.testing.assert_array_equal(
        params["artist_embed"]["embedding"],
        result.state.params.artist_embed.embedding.detach().numpy())


def test_packed_route_and_its_shape_check(mpd, tmp_path):
    from esrecsys_tpu_torch.workloads import playlist as tpl

    cfg = _cfg(mpd, str(tmp_path / "wd"), max_steps=30, eval_every_steps=30,
               train_pattern=f"{mpd}/packed/*.npz",
               test_pattern=f"{mpd}/packed/*.npz", sparse_updates=True)
    result = tpl.train(cfg, device="cpu")
    assert result.steps_run == 30 and result.last_eval_metrics
    assert os.path.exists(f"{cfg.work_dir}/artifacts/playlist-00000030.npz")
    with pytest.raises(ValueError, match="max_next"):
        tpl.train(dataclasses.replace(cfg, max_next=16), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        tpl.train(dataclasses.replace(cfg, n_model_shards=2), device="cpu")


def test_main_trains_checkpoints_and_exports(mpd, tmp_path):
    from esrecsys_tpu_torch.workloads import playlist as tpl

    wd = str(tmp_path / "wd")
    result = tpl.main([
        "--train_pattern", f"{mpd}/*.tfrecord",
        "--test_pattern", f"{mpd}/*.tfrecord",
        "--all_tracks", f"{mpd}/all_tracks.json", "--dictionaries", mpd,
        "--work_dir", wd, "--feature_size", "8", "--album_hash_buckets",
        "16", "--num_artists", "10", "--num_negatives", "8",
        "--batch_size", "4", "--max_next", "8", "--max_steps", "6",
        "--eval_every_steps", "3", "--eval_steps", "4", "--eval_k", "10",
        "--sparse_updates", "true", "--device", "cpu"])
    assert result.steps_run == 6 and result.state.step == 6
    assert os.listdir(f"{wd}/checkpoints") == ["ckpt-00000006.npz"]
    assert os.listdir(f"{wd}/artifacts") == ["playlist-00000006.npz"]
    with open(f"{wd}/config.json") as f:
        assert json.load(f)["sparse_updates"] is True


def _tensors(state):
    out = dict(state.params.state_dict())
    opt = state.opt_state
    if isinstance(opt, torch.optim.Optimizer):
        for n, p in state.params.named_parameters():
            out[f"sgd/{n}"] = opt.state[p]["momentum_buffer"]
    elif opt is not None:
        for t, d in opt.items():
            out[f"{t}/momentum"] = d["momentum"]
    return out


@pytest.mark.parametrize("sparse", [False, True])
def test_resumed_equals_uninterrupted(mpd, tmp_path, sparse):
    from esrecsys_tpu_torch.data import pipelines
    from esrecsys_tpu_torch.workloads import playlist as tpl

    k, n = 7, 12
    cfg = _cfg(mpd, str(tmp_path / "wd"), sparse_updates=sparse,
               max_steps=k, eval_every_steps=5, log_every_steps=5,
               checkpoint_every_steps=4)
    first = tpl.train(cfg, device="cpu")
    assert first.steps_run == k
    cfg = dataclasses.replace(cfg, max_steps=n, resume=True)
    resumed = tpl.train(cfg, device="cpu")
    assert resumed.steps_run == n - k and resumed.state.step == n

    def stream():  # what train() hands fit: its pipeline, first batch off
        it = pipelines.playlist_batches(
            cfg.train_pattern, context_size=cfg.context_size,
            max_next=cfg.max_next, batch_size=cfg.batch_size,
            shuffle_buffer=1000, seed=cfg.seed)
        next(it)
        return it

    a, b = stream(), stream()
    feed = [next(a) for _ in range(k)] + [next(b) for _ in range(n - k)]
    corpus_np = pipelines.load_track_corpus(
        cfg.all_tracks, f"{mpd}/track_uri_dict.json",
        f"{mpd}/album_uri_dict.json", f"{mpd}/artist_uri_dict.json")
    corpus = {key: torch.from_numpy(v) for key, v in corpus_np.items()
              if isinstance(v, np.ndarray)}
    model, state = tpl.init_state(cfg, "cpu")
    step = tpl.select_train_step(model, cfg, corpus, seed=cfg.seed)
    for batch in feed:
        state, _ = step(state, tpl.to_device(batch, torch.device("cpu")))
    want, got = _tensors(state), _tensors(resumed.state)
    assert sorted(want) == sorted(got)
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _wait_for(path, proc, timeout_s=180):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if os.path.exists(path) and os.path.getsize(path) > 0:
            return
        if proc.poll() is not None:
            raise AssertionError(proc.communicate()[0][-3000:])
        time.sleep(0.2)
    raise AssertionError(f"no training progress at {path}")


def _worker(cfg, timeout=None, popen=False):
    cmd = [sys.executable, os.path.abspath(__file__),
           json.dumps(dataclasses.asdict(cfg))]
    env = {**os.environ, "PYTHONPATH": REPO}
    if popen:
        return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    return subprocess.run(cmd, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True,
                          timeout=timeout)


def test_sigterm_checkpoints_and_resumes(mpd, tmp_path):
    """SIGTERM a training subprocess: it exits 0 with a ``PREEMPTED
    <step>`` line and that step's checkpoint as the latest, exports
    nothing, and a resumed run completes from it."""
    from esrecsys_tpu_torch.train import Checkpointer

    cfg = _cfg(mpd, str(tmp_path / "wd"), max_steps=10**9,
               log_every_steps=5, eval_every_steps=0,
               checkpoint_every_steps=10**6)
    proc = _worker(cfg, popen=True)
    try:
        _wait_for(os.path.join(cfg.work_dir, "metrics.jsonl"), proc)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    lines = [x for x in out.splitlines() if x.startswith("PREEMPTED")]
    assert lines, out[-3000:]
    step = int(lines[-1].split()[1])
    assert step >= 5
    assert Checkpointer(f"{cfg.work_dir}/checkpoints").latest_step() == step
    assert not os.path.exists(f"{cfg.work_dir}/artifacts")

    done = _worker(dataclasses.replace(cfg, max_steps=step + 3, resume=True),
                   timeout=180)
    assert done.returncode == 0, done.stdout[-3000:]
    assert f"COMPLETED {step + 3}" in done.stdout.splitlines(), \
        done.stdout[-3000:]
    assert os.path.exists(
        f"{cfg.work_dir}/artifacts/playlist-{step + 3:08d}.npz")


if __name__ == "__main__":
    # the SIGTERM drill's worker: train on the CPU in this process's main
    # thread, where the guard installs its handler
    from esrecsys_tpu_torch.workloads import playlist as tpl

    result = tpl.train(tpl.PlaylistConfig(**json.loads(sys.argv[1])),
                       device="cpu")
    print("PREEMPTED" if result.preempted else "COMPLETED",
          result.state.step, flush=True)
