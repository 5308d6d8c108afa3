"""The port's examples against the reference's, line for line.

Each script in ``examples_torch/`` walks the steps of its counterpart in
``examples/`` and prints the same lines.  On the CPU the reference runs
as a user runs it (``runpy`` as ``__main__``, R1's alias on), the port
through ``main([], device="cpu")``, and the two outputs are compared
line for line.  The few lines that differ by design are normalised on
both sides before the comparison by the rules in ``EXEMPT``, each named
with its reason (the P-number of ROADMAP's Queue 3):

* P6 — sampled tokens (``serving``): ``torch.Generator`` draws other
  numbers than ``jax.random``; the count and the range of the tokens are
  compared;
* P9 — one crypto registry a device: the port's drift report names
  ``crypto@cpu``, the reference's ``crypto``;
* P10 — the port's telemetry also counts its five kernels' launches
  (``kernel_launches_<name>``): five counters more in the metrics
  snapshot;
* P11 — values of the run, not of the computation: wall-clock times,
  trace ids and the paths the exports are written to.

This file holds the core and crypto examples, runs every example
without a device (it must raise ``DeviceUnavailable``) and checks what
each imports; ``test_torch_examples_models.py`` holds the model
examples (two files, so that the suite's workers share them).
"""

import ast
import contextlib
import importlib.util
import io
import re
import runpy
import sys
from pathlib import Path

import pytest

from repro_torch._device import DeviceUnavailable
from test_torch_support import jax_ref, one_thread, reset_torch_state  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
REF_DIR = ROOT / "examples"
PORT_DIR = ROOT / "examples_torch"
EXAMPLES = ("quickstart", "paper_fig1_demo", "crypto_hash", "crypto_block",
            "crypto_aead", "serving", "observe_serving", "train_moe_e2e")
# Held line for line in this file; the model examples (serving,
# observe_serving, train_moe_e2e) in test_torch_examples_models.py.
CRYPTO = EXAMPLES[:5]

pytestmark = pytest.mark.usefixtures("one_thread")


def _tokens(m):
    toks = [int(t) for t in m.group(1).split(",")]
    in_range = all(0 <= t < 4096 for t in toks)
    return f"-> [{len(toks)} tokens, all in [0, 4096): {in_range}]"


def _minus_kernel_counters(m):
    return f"{int(m.group(1)) - 5} counters"


# example -> [(reason, side, pattern, replacement)]; side is "both" or
# "port".  Every other line, and every part of a line a rule leaves, is
# compared as printed.
EXEMPT = {
    "serving": [
        ("P6: sampled tokens", "both", r"-> \[([\d, ]+)\]$", _tokens),
    ],
    "observe_serving": [
        ("P11: trace id", "both", r"trace_id=\d+", "trace_id=<id>"),
        ("P11: span wall time", "both", r"^  (\w+)\s+[\d.]+ ms$",
         r"  \1 <ms>"),
        ("P11: quantile wall times", "both",
         r"(p50|p99|max)=\s*[\d.]+ ms", r"\1=<ms>"),
        ("P11: export path", "both", r"^wrote \S+:", "wrote <path>:"),
        ("P10: five kernel launch counters", "port", r"(\d+) counters$",
         _minus_kernel_counters),
        ("P9: the registry of a device", "port", r"crypto@\w+(:\d+)?:",
         "crypto:"),
    ],
}


def normalise(name, lines, side):
    out = []
    for line in lines:
        for _, where, pattern, repl in EXEMPT.get(name, ()):
            if where in ("both", side):
                line = re.sub(pattern, repl, line)
        out.append(line)
    return out


def load_port(name, directory=PORT_DIR):
    spec = importlib.util.spec_from_file_location(
        f"_example_torch_{name}", directory / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_port(name, argv=(), **kw):
    lines = []
    load_port(name).main(list(argv), device="cpu", log_fn=lines.append,
                         **kw)
    return "\n".join(lines).splitlines()


def run_reference(name):
    """The reference script's stdout; the caller holds ``jax_ref``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(REF_DIR / f"{name}.py"), run_name="__main__")
    return buf.getvalue().splitlines()


def assert_same_lines(name, ref, port):
    ref, port = normalise(name, ref, "ref"), normalise(name, port, "port")
    for i, (r, p) in enumerate(zip(ref, port)):
        assert p == r, f"{name} line {i}: port {p!r} != reference {r!r}"
    assert len(port) == len(ref), (
        f"{name}: {len(port)} lines, the reference prints {len(ref)}")


@pytest.mark.parametrize("name", CRYPTO)
def test_example_prints_reference_lines(name, jax_ref):
    ref = run_reference(name)
    port = run_port(name)
    assert_same_lines(name, ref, port)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_the_card_by_default(name):
    """With no device named, an example runs on the card; there is none
    here, so it raises before it does any work."""
    with pytest.raises(DeviceUnavailable):
        load_port(name).main([], log_fn=lambda s: None)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_torch_numpy_and_the_port_only(name):
    tops = {m.split(".")[0] for m in _imports(PORT_DIR / f"{name}.py")}
    others = tops - {"torch", "numpy", "repro_torch"}
    assert others <= set(sys.stdlib_module_names), others
    assert "torch" in tops or "repro_torch" in tops
