"""Every kernel launch on the card that holds its tensors, on the CPU.

The C entry points launch on the CUDA runtime's current device, so each
wrapper calls one through ``kernels/_build.py::launch``, which makes the
tensors' card current for the call and passes that card's stream. Here,
without a card: the helper with ``torch.cuda.device`` and
``torch.cuda.current_stream`` stubbed; a scan of the wrappers' source that
no entry point which launches a kernel is called any other way; and the
``ctypes`` table against the C entry points' parameters (the MLP tail's
take the card's SM count from the wrapper, and the library keeps no SM
count of its own). The same kernels on a second card:
``tests/test_torch_cuda.py`` (marker ``cuda``).
"""

import ast
import contextlib
import ctypes
import re
import types
from pathlib import Path

import pytest
import torch

from robseg_torch.kernels import _build

KERNELS_DIR = Path(_build.__file__).parent
CSRC_DIR = Path(_build.CSRC_DIR)
# the library's entry points that launch nothing (size and support
# queries), which the wrappers call directly
QUERIES = ("robseg_convnext_block_supported", "robseg_convnext_block_scratch",
           "robseg_convnext_mlp_supported", "robseg_convnext_mlp_scratch")


class _Cards:
    """Stubs of ``torch.cuda.device`` (a guard that makes a card current
    and puts the previous one back) and ``torch.cuda.current_stream`` (one
    stream a card, 1000 + its index)."""

    def __init__(self):
        self.current = 0

    @staticmethod
    def index(card) -> int:
        return card if isinstance(card, int) else torch.device(card).index

    def device(self, card):
        @contextlib.contextmanager
        def guard():
            prev, self.current = self.current, self.index(card)
            try:
                yield
            finally:
                self.current = prev
        return guard()

    def current_stream(self, card):
        return types.SimpleNamespace(cuda_stream=1000 + self.index(card))


@pytest.fixture
def cards(monkeypatch):
    stub = _Cards()
    monkeypatch.setattr(torch.cuda, "device", stub.device)
    monkeypatch.setattr(torch.cuda, "current_stream", stub.current_stream)
    return stub


@pytest.mark.parametrize("index", [1, 3])
def test_launch_makes_the_tensors_card_current(cards, index):
    """The entry point runs with the named card current and gets that
    card's stream after its own arguments; the current card is put back
    after the call."""
    seen = []

    def entry(*args):
        seen.append((cards.current, args))
        return 0

    _build.launch(torch.device("cuda", index), entry, 7, 2.5, None,
                  name="kernel")
    assert seen == [(index, (7, 2.5, None, 1000 + index))]
    assert cards.current == 0


def test_launch_raises_naming_the_kernel(cards):
    """A non-zero return (a CUDA error) raises, naming the kernel; the
    current card is put back all the same."""
    with pytest.raises(RuntimeError,
                       match="apgd_linf_step: CUDA launch failed with error "
                             "700"):
        _build.launch(torch.device("cuda", 2), lambda *a: 700,
                      name="apgd_linf_step")
    assert cards.current == 0


def test_launch_puts_the_card_back_when_the_call_raises(cards):
    def entry(*args):
        raise ctypes.ArgumentError("argument 3: wrong type")

    with pytest.raises(ctypes.ArgumentError):
        _build.launch(torch.device("cuda", 1), entry, name="k")
    assert cards.current == 0


def test_sms_reads_the_named_card(monkeypatch):
    """The SM count the wrappers pass in is the named card's, read on
    every call: cards of two kinds in one process each get their own."""
    sms = {0: 132, 1: 114}
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda card: types.SimpleNamespace(
            multi_processor_count=sms[torch.device(card).index]))
    assert [_build.sms(torch.device("cuda", i)) for i in (1, 0, 1)] == [
        114, 132, 114]


def _is_launch(call: ast.Call) -> bool:
    f = call.func
    return ((isinstance(f, ast.Attribute) and f.attr == "launch"
             and isinstance(f.value, ast.Name) and f.value.id == "_build")
            or (isinstance(f, ast.Name) and f.id == "launch"))


def entry_uses(source: str) -> tuple:
    """(entry points passed to the launch helper, faults) of a module's
    source: a fault is an entry point ``robseg_*`` of the library called
    directly (the size and support queries, ``QUERIES``, aside),
    taken anywhere but as the helper's entry argument, or looked up by a
    string; or a launch whose card is not a tensor's device (``.device``,
    or ``dev``, the FPN wrapper's name for it)."""
    tree = ast.parse(source)
    parent = {c: n for n in ast.walk(tree) for c in ast.iter_child_nodes(n)}
    launched, faults = [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _is_launch(node):
            card = node.args[0] if node.args else None
            if not ((isinstance(card, ast.Attribute)
                     and card.attr == "device")
                    or (isinstance(card, ast.Name) and card.id == "dev")):
                faults.append(f"line {node.lineno}: launch on "
                              f"{ast.unparse(card) if card else None}")
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value.startswith("robseg_")
                and isinstance(parent.get(node), ast.Call)
                and ast.unparse(parent[node].func) == "getattr"):
            faults.append(f"line {node.lineno}: getattr {node.value}")
        if not (isinstance(node, ast.Attribute)
                and node.attr.startswith("robseg_")):
            continue
        up = parent.get(node)
        if isinstance(up, ast.Call) and up.func is node:
            if node.attr not in QUERIES:
                faults.append(f"line {node.lineno}: {node.attr} called "
                              "directly")
        elif (isinstance(up, ast.Call) and _is_launch(up)
              and len(up.args) > 1 and up.args[1] is node):
            launched.append(node.attr)
        else:
            faults.append(f"line {node.lineno}: {node.attr} taken outside "
                          "the launch helper")
    return launched, faults


@pytest.mark.parametrize("path", sorted(p.name for p in
                                        KERNELS_DIR.glob("*.py")))
def test_wrappers_launch_only_through_the_helper(path):
    _, faults = entry_uses((KERNELS_DIR / path).read_text())
    assert faults == []


def test_every_launching_entry_point_goes_through_the_helper():
    """Each entry point of the library that launches a kernel is launched
    somewhere, and only through the helper; the queries launch nothing."""
    launched = set()
    for path in KERNELS_DIR.glob("*.py"):
        launched.update(entry_uses(path.read_text())[0])
    assert launched == set(_build._SIGNATURES) - set(QUERIES)
    assert set(QUERIES) <= set(_build._SIGNATURES)


@pytest.mark.parametrize("snippet,fault", [
    ("err = lib.robseg_confusion(1, 2)", "called directly"),
    ("fn = lib.robseg_confusion\nfn(1, 2)", "outside the launch helper"),
    ("getattr(lib, 'robseg_confusion')(1)", "getattr"),
    ("_build.launch(torch.device('cuda'), lib.robseg_confusion, 1,\n"
     "              name='c')", "launch on torch.device"),
    ("_build.launch(x.device, 1, lib.robseg_confusion, name='c')",
     "outside the launch helper"),
])
def test_scan_finds_a_launch_around_the_helper(snippet, fault):
    assert any(fault in f for f in entry_uses(snippet)[1])


@pytest.mark.parametrize("snippet", [
    "_build.launch(x.device, lib.robseg_confusion, 1, name='c')",
    "_build.launch(dev, _build.library().robseg_fpn_dx, 1, name='f')",
    "n = lib.robseg_convnext_block_scratch(1, 2, 3, 4, 0)",
    "ok = lib.robseg_convnext_mlp_supported(96)",
])
def test_scan_passes_the_helper_and_the_queries(snippet):
    assert entry_uses(snippet)[1] == []


def c_entry_points() -> dict:
    """``{name: (return type, [parameter types])}`` of every ``extern "C"``
    function in ``csrc/*.cu``, as the ``ctypes`` types they map to."""
    def ctype(decl: str):
        decl = decl.strip()
        if "*" in decl:
            return _build._P
        kind = decl.rsplit(None, 1)[0].replace("const ", "").strip()
        return {"int": _build._I, "int64_t": _build._I64,
                "float": _build._F}[kind]

    found = {}
    for src in sorted(CSRC_DIR.glob("*.cu")):
        for ret, name, params in re.findall(
                r'extern "C" (\w+) (robseg_\w+)\(([^)]*)\)', src.read_text()):
            found[name] = (ctype(ret + " r"),
                           [ctype(p) for p in params.split(",")])
    return found


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_ctypes_table_matches_the_c_entry_points(name):
    """Each ``_SIGNATURES`` row has the C function's parameters, in order
    and type (a mismatch would show only as a wrong call on the card)."""
    ret, params = c_entry_points()[name]
    assert _build._SIGNATURES[name] == params
    assert _build._RESTYPES.get(name, ctypes.c_int) == ret


def test_every_c_entry_point_has_a_signature():
    assert set(c_entry_points()) == set(_build._SIGNATURES)


@pytest.mark.parametrize("name", ["robseg_convnext_mlp_fwd",
                                  "robseg_convnext_mlp_dx",
                                  "robseg_convnext_block_fwd",
                                  "robseg_convnext_block_dx"])
def test_persistent_entry_points_take_the_sm_count(name):
    """The entry points whose grids follow the card's SMs take the count
    as an ``int sms`` before the stream, from the wrapper."""
    src = "".join(p.read_text() for p in CSRC_DIR.glob("*.cu"))
    params = re.search(rf'extern "C" \w+ {name}\(([^)]*)\)', src).group(1)
    assert [p.split()[-1] for p in params.split(",")][-2:] == ["sms",
                                                               "stream"]
    assert _build._SIGNATURES[name][-2:] == [_build._I, _build._P]


def test_library_keeps_no_sm_count_of_its_own():
    """No source under csrc/ defines or calls ``sm_count`` or reads the
    multiprocessor count from the current device."""
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        text = src.read_text()
        assert not re.search(r"\bsm_count\s*\(", text), src.name
        assert "cudaDevAttrMultiProcessorCount" not in text, src.name
