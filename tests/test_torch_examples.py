"""The port's examples ladder against the JAX package's.

``parsec_tpu_torch/examples`` holds Ex00–Ex12; each ``main()``
self-checks, and returns what the JAX example's ``main()`` returns.
Values that depend on scheduling (Ex06's racy readers, the serving
layer's timings and batch counts) are compared by what they must hold
in both.  As in the JAX
package's ``tests/test_examples.py``, every pool an example enqueues
passes graphcheck on its way in (the ``analysis_check`` param).  Ex08
and Ex12 run on the device module around the host (``device="cpu"``);
Ex08's error is held under the JAX example's own ``1e-3`` on both
sides.
"""

import importlib
import importlib.util
import pathlib
import time

import pytest

from parsec_tpu_torch.core.params import params as port_params

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_DIR = ROOT / "parsec_tpu_torch" / "examples"
LADDER = ["Ex00_StartStop", "Ex01_HelloWorld", "Ex02_Chain",
          "Ex03_ChainMPI", "Ex04_ChainData", "Ex05_Broadcast", "Ex06_RAW",
          "Ex07_RAW_CTL", "Ex08_Recursive", "Ex09_DTD_Tree",
          "Ex10_WireHalo", "Ex11_Serve", "Ex12_LLMServe"]


def _jax_example(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ladder_is_complete():
    assert sorted(p.stem for p in PORT_DIR.glob("Ex*.py")) == LADDER
    for name in LADDER:
        assert (ROOT / "examples" / f"{name}.py").is_file(), name


@pytest.fixture
def gated(param):
    import parsec_tpu.runtime.context  # noqa: F401 (registers the param)
    import parsec_tpu_torch.runtime.context  # noqa: F401 (the port's)
    param("analysis_check", 1)
    old = port_params.get("analysis_check")
    port_params.set("analysis_check", 1)
    yield
    port_params.set("analysis_check", old)


def _compare(name, got, want):
    if name == "Ex06_RAW":
        (seen, final), (jseen, jfinal) = got, want
        assert final == jfinal == 700.0 and len(seen) == len(jseen) == 4
        assert set(seen) <= {7.0, 700.0} and set(jseen) <= {7.0, 700.0}
    elif name == "Ex07_RAW_CTL":
        assert got[-1] == want[-1] == ("update",)
        assert sorted(got) == sorted(want)
    elif name == "Ex11_Serve":
        for k in ("submitted", "completed", "failed", "rejected",
                  "per_tenant_completed"):
            assert got[k] == want[k], k
    elif name == "Ex08_Recursive":
        assert 0.0 <= got < 1e-3 and 0.0 <= want < 1e-3
    elif name == "Ex12_LLMServe":
        for k in ("streams_completed", "tokens_generated"):
            assert got["llm"][k] == want["llm"][k], k
        assert got["llm"]["kv"]["physical_pages"] == \
            want["llm"]["kv"]["physical_pages"] == 0
        assert got["completed"] == want["completed"], \
            (got["completed"], want["completed"])
    else:
        assert got == want


@pytest.fixture
def registry_restored():
    """Ex08 and Ex12 register the device module around the host; other
    files count its tasks from zero, so it is unregistered after."""
    from parsec_tpu_torch.device import registry
    snapshot = list(registry.devices)
    yield
    registry.devices = snapshot
    for i, d in enumerate(registry.devices):
        d.device_index = i


def _admit_in_one_wave(monkeypatch, n):
    """Hold each package's batcher loop until ``n`` streams are queued,
    so Ex12's four streams are admitted in one wave in both runs (its
    pool count depends on the waves: one wave or two)."""
    import parsec_tpu.llm.batcher as jb
    import parsec_tpu_torch.llm.batcher as pb
    for mod in (jb, pb):
        orig = mod.ContinuousBatcher._loop

        def loop(self, orig=orig):
            deadline = time.monotonic() + 60
            while len(self._pending) < n and time.monotonic() < deadline:
                time.sleep(0.001)
            orig(self)

        monkeypatch.setattr(mod.ContinuousBatcher, "_loop", loop)


@pytest.mark.parametrize("name", LADDER)
def test_example_returns_what_the_jax_example_returns(name, gated,
                                                      registry_restored,
                                                      monkeypatch):
    if name == "Ex12_LLMServe":
        _admit_in_one_wave(monkeypatch, 4)
    mod = importlib.import_module(f"parsec_tpu_torch.examples.{name}")
    got = (mod.main(device="cpu")
           if name in ("Ex08_Recursive", "Ex12_LLMServe") else mod.main())
    want = _jax_example(name).main()
    _compare(name, got, want)
