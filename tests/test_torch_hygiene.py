"""Boundaries of the PyTorch port: it imports neither JAX nor anything of
the JAX package, nor cv2, h5py, PIL, imageio, matplotlib, tensorflow or
torchvision (the card's machine has none of them), builds nothing at
import, its entry points run on the card unless asked for the CPU, and its
kernel wrappers take the plain version only for CPU tensors."""

import ast
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "casmtr_tpu_torch")
KERNEL_WRAPPERS = {
    "quadtree_kernels.py": ("quadtree_fine_attention",
                            "quadtree_fine_attention_bwd",
                            "quadtree_fine_topk"),
    "window_kernels.py": ("window_patch_score", "window_cross_attention",
                          "window_patch_score_bwd",
                          "window_cross_attention_bwd"),
}


def _sources():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    out.append(os.path.join(REPO, "chip_smoke.py"))
    return sorted(out)


FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "cv2", "casmtr_tpu",
                     "h5py", "PIL", "imageio", "matplotlib", "tensorflow",
                     "torchvision")
IMPORTED = ("casmtr_tpu_torch", "casmtr_tpu_torch.serving",
            "casmtr_tpu_torch.models.casmtr", "casmtr_tpu_torch.data.io",
            "casmtr_tpu_torch.data.module", "casmtr_tpu_torch.cli.evaluate",
            "casmtr_tpu_torch.cli.train", "casmtr_tpu_torch.cli.match_pair",
            "casmtr_tpu_torch.cli.reconstruct", "casmtr_tpu_torch.sfm.pipeline",
            "casmtr_tpu_torch.parallel.comm")


def _build_tree():
    root = os.path.join(PKG, "_build")
    return sorted(os.path.relpath(os.path.join(r, f), root)
                  for r, _, fs in os.walk(root) for f in fs)


def test_import_pulls_in_no_jax_and_no_jax_package():
    """Importing the port, its data layer and its commands loads none of
    the forbidden modules and builds nothing (``_build/`` unchanged)."""
    before = _build_tree()
    code = (f"import sys, {', '.join(IMPORTED)}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN_MODULES!r}]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert _build_tree() == before


_FORBIDDEN = [
    re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|cv2|h5py|PIL|"
               r"imageio|matplotlib|tensorflow|torchvision)\b", re.M),
    re.compile(r"casmtr_tpu\."),
    re.compile(r"\bimport\s+casmtr_tpu(?!_torch)\b"),
    re.compile(r"\bfrom\s+casmtr_tpu\s+import\b"),
]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_names_no_jax_import(path):
    with open(path) as f:
        text = f.read()
    for pat in _FORBIDDEN:
        assert not pat.search(text), f"{path}: {pat.pattern}"


def test_matcher_defaults_to_cuda_and_raises_without_it():
    from casmtr_tpu_torch.serving import Matcher
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        Matcher("outdoor_casmtr_4c", bucket=64, df=32)


def _is_cpu_branch(node: ast.If) -> bool:
    return re.fullmatch(r"\w+\.device\.type == 'cpu'",
                        ast.unparse(node.test)) is not None


def _plain_calls(node, inside_cpu_branch=False):
    """Yield (call, inside_cpu_branch) for every call of a *_plain function
    under ``node``."""
    if isinstance(node, ast.Call):
        name = ast.unparse(node.func)
        if name.endswith("_plain"):
            yield node, inside_cpu_branch
    for child in ast.iter_child_nodes(node):
        in_cpu = inside_cpu_branch
        if isinstance(node, ast.If) and _is_cpu_branch(node) \
                and child in node.body:
            in_cpu = True
        yield from _plain_calls(child, in_cpu)


@pytest.mark.parametrize("fname", sorted(KERNEL_WRAPPERS))
def test_kernel_wrappers_never_fall_back(fname):
    """No try/except anywhere near a build or a launch, and the plain
    version is called only in the wrapper's CPU-tensor branch."""
    with open(os.path.join(PKG, "ops", "kernels", fname)) as f:
        tree = ast.parse(f.read())
    with open(os.path.join(PKG, "ops", "kernels", "__init__.py")) as f:
        build = ast.parse(f.read())
    for t in (tree, build):
        assert not any(isinstance(n, ast.Try) for n in ast.walk(t))
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    for wrapper in KERNEL_WRAPPERS[fname]:
        calls = list(_plain_calls(funcs[wrapper]))
        assert calls and all(inside for _, inside in calls), wrapper
        first = funcs[wrapper].body[1]  # after the docstring
        assert isinstance(first, ast.If) and _is_cpu_branch(first)


def test_plain_versions_are_called_only_by_their_wrappers():
    """Outside the kernel modules, nothing in the port calls a plain
    version: on the card the main path reaches only the kernels."""
    for path in _sources():
        if os.path.dirname(path) == os.path.join(PKG, "ops", "kernels"):
            continue
        with open(path) as f:
            tree = ast.parse(f.read())
        if path.endswith("chip_smoke.py"):
            continue  # compares each kernel with its plain version
        assert not list(_plain_calls(tree)), path
