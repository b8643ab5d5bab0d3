"""Import hygiene of the PyTorch port: ``paddle_tpu_torch`` and
``chip_smoke.py`` import neither JAX nor anything of ``paddle_tpu`` —
checked statically over every source file, and at run time in a fresh
interpreter."""
import ast
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    out = [os.path.join(_REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(_REPO, "paddle_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, _REPO))
def test_source_imports_no_jax_and_no_paddle_tpu(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{os.path.relpath(path, _REPO)} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import paddle_tpu_torch, paddle_tpu_torch.ops\n"
            "import paddle_tpu_torch.ops.paged_attention\n"
            "import paddle_tpu_torch.models, paddle_tpu_torch.serving\n"
            "import paddle_tpu_torch.amp, paddle_tpu_torch.nn\n"
            "import paddle_tpu_torch.optimizer, paddle_tpu_torch.jit\n"
            "import paddle_tpu_torch.incubate\n"
            "import paddle_tpu_torch.jit.__main__\n"
            "import paddle_tpu_torch.serving.__main__\n"
            "import paddle_tpu_torch.static, paddle_tpu_torch.static.passes\n"
            "import paddle_tpu_torch.static.passes.__main__\n"
            "import paddle_tpu_torch.analysis.pass_check\n"
            "import paddle_tpu_torch.distributed.passes\n"
            "import paddle_tpu_torch.flags, paddle_tpu_torch.observability\n"
            "import paddle_tpu_torch.inference.serving\n"
            "import paddle_tpu_torch.resilience.retry\n"
            "import paddle_tpu_torch.resilience.driver\n"
            "import paddle_tpu_torch.tuning, paddle_tpu_torch.tuning.cache\n"
            "import paddle_tpu_torch.tuning.__main__\n"
            "import paddle_tpu_torch.serving.fleet\n"
            "import paddle_tpu_torch.serving.fleet.__main__\n"
            "import paddle_tpu_torch.distributed.fleet\n"
            "import paddle_tpu_torch.distributed.sharding\n"
            "import paddle_tpu_torch.distributed.fleet.recompute\n"
            "import paddle_tpu_torch.distributed.launch.main\n"
            "import paddle_tpu_torch.distributed.fleet.meta_parallel\n"
            "import paddle_tpu_torch.distributed.fleet.meta_parallel"
            ".parallel_layers\n"
            "import paddle_tpu_torch.distributed.fleet.meta_parallel"
            ".segment_parallel\n"
            "import paddle_tpu_torch.distributed.fleet.meta_parallel"
            ".tensor_parallel\n"
            "import paddle_tpu_torch.distributed.fleet.utils"
            ".sequence_parallel_utils\n"
            "import paddle_tpu_torch.ops.ring_attention\n"
            "import paddle_tpu_torch.ops.ulysses\n"
            "import paddle_tpu_torch.nn.initializer\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'paddle_tpu'))\n"
            "print(','.join(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""
