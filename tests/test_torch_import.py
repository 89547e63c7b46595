"""The port package stands alone: it imports neither JAX nor the reference
package (only the tests import both), nor Pillow, OpenCV or fontTools,
which the card's machine does not have. The exceptions are the scripts
run by hand where Pillow is installed (the glyph-table generator and the
font fixtures' maker), which may import Pillow (and nothing else
forbidden)."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ckrenderengine_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "ckrenderengine_tpu", "PIL", "cv2",
             "fontTools")
# Scripts run by hand, never imported by the package (paths from the
# repository's root): what each may import.
HAND_RUN = {
    os.path.join("ckrenderengine_tpu_torch", "objects",
                 "make_glyph_table.py"): ("PIL",),
    os.path.join("tests", "torch_fonts", "make_fonts.py"): ("PIL",),
    os.path.join("tests", "torch_images", "make_images.py"): ("PIL", "cv2"),
}


def _modules():
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _forbidden(name: str, allowed=()) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN and top not in allowed


def test_import_with_jax_and_reference_blocked():
    """Every module of the port imports in a process where importing jax,
    ckrenderengine_tpu, PIL, cv2 or fontTools fails."""
    mods = sorted(
        "ckrenderengine_tpu_torch." + os.path.relpath(p, PKG)[:-3].replace(
            os.sep, ".").replace(".__init__", "")
        for p in _modules())
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import sys\n"
        f"for m in {FORBIDDEN!r}:\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(_modules()) + [
    os.path.join(ROOT, "chip_smoke.py"),
    os.path.join(ROOT, "tests", "torch_fonts", "make_fonts.py"),
    os.path.join(ROOT, "tests", "torch_images", "make_images.py")],
    ids=lambda p: os.path.relpath(p, ROOT))
def test_module_has_no_reference_import(path):
    """No import statement (or __import__/import_module call) of the port,
    of ``chip_smoke.py``, of ``make_fonts.py`` or of ``make_images.py``
    names jax, the reference package, PIL, cv2 or fontTools (the hand-run
    scripts of HAND_RUN only what they list)."""
    allowed = HAND_RUN.get(os.path.relpath(path, ROOT), ())
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("__import__", "import_module")):
            names = [node.args[0].value]
        else:
            continue
        assert not any(_forbidden(n, allowed) for n in names), (path, names)
