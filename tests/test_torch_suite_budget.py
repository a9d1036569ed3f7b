"""The port's CPU tests keep to the sizes of ``tests/_stream_bases.py``.

Each frame size is a set of the reference's JAX programs (the frame
cores are keyed on ``mbw``/``mbh``), and tracing and compiling those
programs is most of what the port's tests cost on the CPU.  This guard
times nothing: it reads the sources of the port's test files that call
the reference and collects the frame sizes their stream and encoder
cases name -- ``width=``/``height=`` pairs in one call or dict, ``W, H =``
assignments and the rows of a ``"w,h,..."`` parametrization -- and fails
when a size is missing from ``SIZES``, which says why each size is used.
A new size goes into that table with its reason, or the case moves onto
a size that is there."""

import ast
import pathlib

import pytest

import _stream_bases
from _stream_bases import SIZES

TESTS = pathlib.Path(__file__).resolve().parent


def _calls_reference(tree) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and (
                node.module == "x264_tpu"
                or node.module.startswith("x264_tpu.")):
            return True
        if isinstance(node, ast.Import) and any(
                a.name == "x264_tpu" or a.name.startswith("x264_tpu.")
                for a in node.names):
            return True
    return False


FILES = sorted(p.name for p in TESTS.glob("test_torch_*.py")
               if _calls_reference(ast.parse(p.read_text())))


def _int(node):
    if isinstance(node, ast.Constant) and type(node.value) is int:
        return node.value
    return None


def _pair(width, height):
    w, h = _int(width), _int(height)
    return None if w is None or h is None else (w, h)


def sizes_named(source: str) -> list:
    """The (width, height) pairs the source names as literals, each with
    its line."""
    tree = ast.parse(source)
    tables = {t.id: node.value for node in tree.body
              if isinstance(node, ast.Assign) for t in node.targets
              if isinstance(t, ast.Name)}
    found = []

    def add(pair, node):
        if pair is not None:
            found.append((pair, node.lineno))

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            kw = {k.arg: k.value for k in node.keywords if k.arg}
            if "width" in kw and "height" in kw:
                add(_pair(kw["width"], kw["height"]), node)
            fn = node.func
            name = getattr(fn, "attr", getattr(fn, "id", ""))
            if name == "parametrize" and node.args and isinstance(
                    node.args[0], ast.Constant) and str(
                    node.args[0].value).replace(" ", "").startswith("w,h,"):
                rows = node.args[1]
                if isinstance(rows, ast.Name):
                    rows = tables.get(rows.id, rows)
                for row in getattr(rows, "elts", ()):
                    if isinstance(row, ast.Tuple) and len(row.elts) >= 2:
                        add(_pair(*row.elts[:2]), row)
        elif isinstance(node, ast.Dict):
            kv = {k.value: v for k, v in zip(node.keys, node.values)
                  if isinstance(k, ast.Constant)}
            if "width" in kv and "height" in kv:
                add(_pair(kv["width"], kv["height"]), node)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Tuple) and isinstance(node.value,
                                                            ast.Tuple)
                        and [getattr(e, "id", "").lower()
                             for e in t.elts] == ["w", "h"]):
                    add(_pair(*node.value.elts), node)
    return found


@pytest.mark.parametrize("name", FILES)
def test_port_test_sizes_are_named_in_the_bases(name):
    stray = [(size, line) for size, line in
             sizes_named((TESTS / name).read_text()) if size not in SIZES]
    assert not stray, (
        f"{name} brings frame sizes that tests/_stream_bases.py's SIZES "
        f"does not name (size, line): {stray}")


def _imported_sizes(source: str) -> set:
    """The sizes a file takes by name from tests/_stream_bases.py."""
    return {getattr(_stream_bases, a.name) for node in
            ast.walk(ast.parse(source)) if isinstance(node, ast.ImportFrom)
            and node.module == "_stream_bases" for a in node.names
            if isinstance(getattr(_stream_bases, a.name), tuple)}


def test_every_named_size_is_used_and_the_guard_reads_them():
    """No size stays in the table without a case that names it, as a
    literal or by its name in the bases, and the reader finds the forms
    the files use, so that the guard above cannot pass empty."""
    used, literals = set(), 0
    for name in FILES:
        src = (TESTS / name).read_text()
        found = sizes_named(src)
        literals += len(found)
        used |= {s for s, _ in found} | _imported_sizes(src)
    assert set(SIZES) <= used, set(SIZES) - used
    assert literals >= 20, literals
    src = "\n".join([
        "W, H = 96, 64", "f(width=350, height=286)",
        "d = {'width': 48, 'height': 32}",
        "G = [(64, 48, 1)]", "@pytest.mark.parametrize('w,h,qp', G)",
        "def t(w, h, qp): pass"])
    assert sorted(s for s, _ in sizes_named(src)) == [
        (48, 32), (64, 48), (96, 64), (350, 286)]
