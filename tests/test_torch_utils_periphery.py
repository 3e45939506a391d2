"""The port's periphery (``parallax_tpu_torch/{version,utils/version_check,
utils/banner,utils/compile_cache}.py``) against the JAX package's
(tests/test_utils_periphery.py): the release probe offline within its
timeout, the banner, the compilation-cache directory's resolution, a
library built once and loaded by a second process with no build, the
draft proposer's recorded directory, and the CLI flags that are no longer
refused."""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import pytest
import torch

import tests._torch_cpu  # noqa: F401  (one intra-op thread)

from parallax_tpu_torch import cli, native
from parallax_tpu_torch.ops import cuda_kernels
from parallax_tpu_torch.utils import banner as banner_mod
from parallax_tpu_torch.utils import compile_cache
from parallax_tpu_torch.utils import version_check as vc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_BUILD = os.path.join(REPO, "parallax_tpu_torch", "_build")


@pytest.fixture
def cache_state(monkeypatch):
    """Every global the compile cache sets, restored after the test."""
    monkeypatch.setattr(cuda_kernels, "BUILD_DIR", cuda_kernels.BUILD_DIR)
    monkeypatch.setattr(native, "BUILD_DIR", native.BUILD_DIR)
    monkeypatch.setattr(compile_cache, "_active_path",
                        compile_cache._active_path)
    monkeypatch.delenv("PARALLAX_TPU_COMPILE_CACHE", raising=False)
    return monkeypatch


# -- version and release probe ------------------------------------------------


def test_version_check_offline_graceful(monkeypatch):
    from parallax_tpu.utils import version_check as jvc

    assert vc.get_current_version() == jvc.get_current_version() != ""
    monkeypatch.setattr(vc, "RELEASES_URL", "http://127.0.0.1:1/none")
    t0 = time.monotonic()
    assert vc.get_latest_version(timeout=0.2) is None
    assert vc.check_latest_release() is None  # unknown latest -> quiet
    assert time.monotonic() - t0 < 5.0


def test_release_probe_dials_nothing_without_a_url(monkeypatch):
    """The port probes only a URL the operator names: with none set it
    answers None at once, opening no connection."""
    import urllib.request

    def refuse(*a, **k):
        raise AssertionError("the probe dialed out")

    monkeypatch.setattr(vc, "RELEASES_URL", "")
    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    assert vc.get_latest_version() is None
    assert vc.check_latest_release() is None


def test_release_probe_reads_a_local_release(monkeypatch):
    """A newer release at the configured URL gives the upgrade hint."""
    import http.server

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            body = json.dumps({"tag_name": "v9.9.9"}).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        monkeypatch.setattr(
            vc, "RELEASES_URL",
            f"http://127.0.0.1:{server.server_address[1]}/latest")
        assert vc.get_latest_version(timeout=5.0) == "9.9.9"
        hint = vc.check_latest_release()
        assert hint and "9.9.9" in hint and vc.get_current_version() in hint
    finally:
        server.shutdown()
        server.server_close()


# -- banner -----------------------------------------------------------------------


def test_banner_contains_version_and_device_line(capsys):
    from parallax_tpu.utils.banner import banner as jbanner

    text = banner_mod.banner(device_line="NVIDIA H100 80GB HBM3")
    assert vc.get_current_version() in text
    assert "NVIDIA H100 80GB HBM3" in text
    assert "PyTorch + CUDA" in text and "TPU" not in text
    # Plain text off a TTY, as the JAX banner.
    assert "\x1b[" not in text
    assert "\x1b[" not in jbanner(device_line="x")
    assert banner_mod.device_line("cpu") == "cpu"
    banner_mod.print_banner("cpu")
    assert capsys.readouterr().out == banner_mod.banner("cpu")


@pytest.mark.parametrize("opt_out", [False, True], ids=["probe", "opt-out"])
def test_boot_probes_on_a_daemon_thread(monkeypatch, capsys, opt_out):
    """The banner goes out first; the release probe runs on a daemon
    thread of its own (never on the caller's), unless opted out."""
    seen, done = [], threading.Event()

    def probe():
        t = threading.current_thread()
        seen.append((t.name, t.daemon))
        done.set()

    monkeypatch.setattr(vc, "check_latest_release", probe)
    if opt_out:
        monkeypatch.setenv("PARALLAX_TPU_NO_VERSION_CHECK", "1")
    else:
        monkeypatch.delenv("PARALLAX_TPU_NO_VERSION_CHECK", raising=False)
    banner_mod.boot("cpu")
    assert "  cpu" in capsys.readouterr().out
    if opt_out:
        assert not done.wait(0.5) and not seen
        return
    assert done.wait(10)
    assert seen == [("version-check", True)]


# -- the compilation cache ------------------------------------------------------


@pytest.mark.parametrize("how", ["argument", "environment", "off",
                                 "default"])
def test_compile_cache_resolution(cache_state, tmp_path, how):
    """The argument wins, then PARALLAX_TPU_COMPILE_CACHE, then the
    package's ``_build/``; ``off`` builds into a private temporary
    directory. Both builds point at the choice, which is returned."""
    from parallax_tpu.utils import compile_cache as jcc

    if how == "argument":
        cache_state.setenv("PARALLAX_TPU_COMPILE_CACHE", str(tmp_path / "e"))
        want = str(tmp_path / "a")
        got = compile_cache.enable_compilation_cache(want)
    elif how == "environment":
        want = str(tmp_path / "e")
        cache_state.setenv("PARALLAX_TPU_COMPILE_CACHE", want)
        got = compile_cache.enable_compilation_cache()
    elif how == "off":
        got = compile_cache.enable_compilation_cache("off")
        # The JAX package turns its cache off; the port keeps building,
        # privately, so no process reuses another's libraries.
        assert jcc.enable_compilation_cache("off") is None
        assert got and os.path.basename(got).startswith("parallax_build_")
        assert os.path.dirname(got) == tempfile.gettempdir()
        want = got
    else:
        want = DEFAULT_BUILD
        got = compile_cache.enable_compilation_cache()
    assert got == want and os.path.isdir(got)
    assert compile_cache.active_cache_dir() == got
    assert cuda_kernels.BUILD_DIR == native.BUILD_DIR == got
    assert native.library_path().startswith(got + os.sep)


def test_compile_cache_never_raises(cache_state, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    before = compile_cache.active_cache_dir()
    assert compile_cache.enable_compilation_cache(str(blocker / "d")) is None
    assert compile_cache.active_cache_dir() == before


def test_register_compile_counter_is_idempotent_and_counts_builds(
        monkeypatch):
    from parallax_tpu_torch.obs import device, goodput, registry
    from parallax_tpu_torch.obs.device import get_device_plane, note_build

    # Fresh process-wide planes: the build noted here must not reach
    # another test's counts.
    monkeypatch.setattr(registry, "_REGISTRY", registry.MetricsRegistry())
    monkeypatch.setattr(device, "_PLANE", device.DevicePlane())
    monkeypatch.setattr(goodput, "_LEDGER", goodput.GoodputLedger())
    monkeypatch.setattr(compile_cache, "_counter_registered", False)
    compile_cache.register_compile_counter()
    compile_cache.register_compile_counter()
    plane = get_device_plane()
    assert plane.compile._c_compiles is not None
    before = compile_cache.build_counts()
    note_build("native_build", {"lib": "x"}, 0.01)
    after = compile_cache.build_counts()
    assert after["native_build"] == before["native_build"] + 1
    assert after["kernel_build"] == before["kernel_build"]


_BUILD_PROBE = """
import json, sys
from parallax_tpu_torch.utils import compile_cache
from parallax_tpu_torch import native
d = compile_cache.enable_compilation_cache(sys.argv[1])
assert native.load_library() is not None, native.build_error
print(json.dumps({"dir": d, "lib": native.library_path(),
                  "builds": compile_cache.build_counts()}))
"""


def test_native_library_builds_once_then_loads(tmp_path):
    """The radix library builds once into the cache directory; a second
    process pointed there builds nothing and counts no compile (g++ is
    here; nvcc is not, so the kernel library takes the card's check)."""
    if not native.native_available():
        pytest.skip("g++ cannot build the native library")
    cache = str(tmp_path / "cache")
    outs = []
    for _ in range(2):
        res = subprocess.run(
            [sys.executable, "-c", _BUILD_PROBE, cache], cwd=REPO,
            capture_output=True, text=True, timeout=180,
            env={**os.environ, "PYTHONPATH": REPO})
        assert res.returncode == 0, res.stderr
        outs.append(json.loads(res.stdout.strip().splitlines()[-1]))
    assert outs[0]["dir"] == outs[1]["dir"] == cache
    assert outs[0]["lib"] == outs[1]["lib"]
    assert os.path.dirname(outs[0]["lib"]) == cache
    assert outs[0]["builds"] == {"kernel_build": 0, "native_build": 1}
    assert outs[1]["builds"] == {"kernel_build": 0, "native_build": 0}
    assert sorted(os.listdir(cache)) == [os.path.basename(outs[0]["lib"])]


def test_draft_proposer_records_the_active_compile_cache(cache_state,
                                                         tmp_path):
    """Speculation pays no second build: the proposer records the
    directory the process already chose, and never re-points it."""
    from parallax_tpu_torch.config import normalize_config
    from parallax_tpu_torch.models import create_stage_model
    from parallax_tpu_torch.runtime.engine import (
        DraftProposer,
        EngineConfig,
        StageEngine,
    )

    active = compile_cache.enable_compilation_cache(str(tmp_path / "c"))
    cfg = normalize_config(dict(
        architectures=["Qwen2ForCausalLM"], hidden_size=32,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
        intermediate_size=64, vocab_size=50))
    model = create_stage_model(cfg, 0, 1)
    eng = StageEngine(model, model.init_params(
        torch.Generator().manual_seed(0), torch.float32, "cpu"),
        EngineConfig(num_pages=16), device="cpu")
    draft = DraftProposer(eng)
    assert draft.compile_cache_dir == active
    assert compile_cache.active_cache_dir() == active
    assert native.BUILD_DIR == active


# -- the CLI --------------------------------------------------------------------


@pytest.mark.parametrize("argv", [
    ["serve", "--compilation-cache-dir", "CACHE"],
    ["generate", "--compilation-cache-dir", "off"],
    ["join", "--refit-cache-dir", "REFIT", "--compilation-cache-dir",
     "CACHE", "--start-layer", "0", "--end-layer", "2"],
], ids=["serve", "generate", "join"])
def test_cli_accepts_the_periphery_flags(cache_state, tmp_path, argv):
    """``--compilation-cache-dir`` and ``--refit-cache-dir`` pass; a join
    built from them points the builds at the cache and keeps a refit
    store at its directory."""
    from parallax_tpu_torch.p2p.join import build_worker

    with open(tmp_path / "config.json", "w") as f:
        json.dump(dict(architectures=["Qwen2ForCausalLM"], hidden_size=32,
                       num_hidden_layers=2, num_attention_heads=2,
                       num_key_value_heads=1, intermediate_size=64,
                       vocab_size=50), f)
    argv = [a.replace("CACHE", str(tmp_path / "cache")).replace(
        "REFIT", str(tmp_path / "refit")) for a in argv]
    args = cli.build_parser().parse_args(
        [argv[0], "--model-path", str(tmp_path), *argv[1:]])
    assert cli.unported_flags(args) == []
    if argv[0] != "join":
        return
    args.device = "cpu"
    args.advertise_addr = "127.0.0.1"
    node = build_worker(args)
    node.transport.stop()
    assert node.refit_store is not None
    assert node.refit_store.root == str(tmp_path / "refit")
    assert compile_cache.active_cache_dir() == str(tmp_path / "cache")
    assert native.BUILD_DIR == str(tmp_path / "cache")


def test_hub_model_path_refusal_names_no_item(tmp_path, capsys):
    """No ROADMAP item ports a hub download: the refusal says what the
    port reads instead of naming one."""
    for argv in (["serve", "--model-path", "Qwen/Qwen2.5-7B"],
                 ["join", "--model-path", "Qwen/Qwen2.5-7B"]):
        args = cli.build_parser().parse_args(argv)
        refused = cli.unported_flags(args)
        assert [item for _, item in refused] == [None]
        assert cli.main(argv) == 2
        err = capsys.readouterr().err
        assert "hub download" in err and "local checkpoint" in err
        assert "item" not in err and "not ported" not in err
