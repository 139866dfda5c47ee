"""The PyTorch/CUDA port's deploy image (deploy/Dockerfile.cuda and
deploy/requirements-lock-cuda.txt), checked statically: building it
needs a base-image pull.  Its CUDA release and the lock's torch wheel
agree; the lock pins every package exactly and holds no jax; every path
it copies exists; what it copies holds every file of setup.py's package
data for vapor_tpu_torch; its entry point is setup.py's console script
for the port."""
import ast
import glob
import os
import re

from vapor_tpu_torch.engine.kernels import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCKERFILE = os.path.join(ROOT, "deploy", "Dockerfile.cuda")
LOCK = os.path.join(ROOT, "deploy", "requirements-lock-cuda.txt")


def _instructions():
    """(instruction, argument) pairs of the Dockerfile, continuation
    lines joined and comments dropped."""
    with open(DOCKERFILE) as fh:
        text = re.sub(r"\\\n", " ", fh.read())
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            word, _, rest = line.partition(" ")
            out.append((word.upper(), rest.strip()))
    return out


def _pins():
    with open(LOCK) as fh:
        lines = [x.strip() for x in fh
                 if x.strip() and not x.startswith("#")]
    return dict(x.split("==") for x in lines), lines


def _setup_kwargs():
    with open(os.path.join(ROOT, "setup.py")) as fh:
        tree = ast.parse(fh.read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call) and
                getattr(n.func, "id", None) == "setup")
    return {k.arg: ast.literal_eval(k.value) for k in call.keywords
            if k.arg in ("package_data", "entry_points")}


def test_cuda_release_and_torch_wheel_agree():
    pins, _ = _pins()
    assert pins["torch"] == "2.11.0+cu128"
    base = [arg for word, arg in _instructions() if word == "FROM"]
    assert base == ["nvidia/cuda:12.8.1-devel-ubuntu24.04"]
    runs = " ".join(arg for word, arg in _instructions() if word == "RUN")
    assert "download.pytorch.org/whl/cu128" in runs
    assert "g++" in runs and "zlib1g-dev" in runs


def test_lock_pins_exactly_and_holds_no_jax():
    pins, lines = _pins()
    assert all(re.fullmatch(r"[A-Za-z0-9_.\-]+==[A-Za-z0-9_.+\-]+", x)
               for x in lines)
    assert not any(name.lower().startswith("jax") for name in pins)
    assert {"torch", "numpy", "scipy", "matplotlib"} <= set(pins)


def test_copied_paths_exist_and_hold_the_package_data():
    copies = [arg.split() for word, arg in _instructions()
              if word == "COPY"]
    sources = [src for *srcs, _ in copies for src in srcs]
    assert sources == ["deploy/requirements-lock-cuda.txt", "setup.py",
                       "vapor_tpu_torch"]
    for src in sources:
        assert os.path.exists(os.path.join(ROOT, src)), src
    data = _setup_kwargs()["package_data"]["vapor_tpu_torch"]
    assert "engine/kernels/csrc/*.cu" in data and "native/*.cpp" in data
    for pattern in data:
        assert glob.glob(os.path.join(ROOT, "vapor_tpu_torch", pattern)), \
            pattern
    kernels = sorted(os.path.basename(x) for x in glob.glob(os.path.join(
        ROOT, "vapor_tpu_torch", "engine", "kernels", "csrc", "*.cu")))
    # the six dot-plot kernels and the three glue kernels, each of which
    # build.build() compiles in the image
    assert len(kernels) == 9
    assert kernels == sorted(build.source(name) for name in
                             (*build.ENTRY_POINTS, *build.GLUE_POINTS))


def test_entry_point_is_the_ports_console_script():
    script = "vapor-tpu-torch"
    scripts = dict(x.split("=") for x in
                   _setup_kwargs()["entry_points"]["console_scripts"])
    assert scripts[script] == "vapor_tpu_torch.cli:main"
    entry = [arg for word, arg in _instructions() if word == "ENTRYPOINT"]
    assert [ast.literal_eval(x) for x in entry] == [[script]]
    installs = [arg for word, arg in _instructions() if word == "RUN" and
                "pip install" in arg and "-e ." in arg]
    assert installs and all("--no-deps" in x for x in installs)
