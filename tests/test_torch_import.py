"""The port stands alone: it imports with JAX, Flax and the JAX package
blocked, and its sources name none of them."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'basicsr4rs_tpu')


def test_port_imports_without_jax():
    code = ('import sys\n'
            f'for name in {BLOCKED!r}:\n'
            '    sys.modules[name] = None\n'
            'import basicsr4rs_torch, basicsr4rs_torch.test\n'
            'from basicsr4rs_torch.ops import swin_block\n'
            'assert not any(m.split(".")[0] in {"jax", "flax", "basicsr4rs_tpu"} '
            'for m in sys.modules if sys.modules[m] is not None)\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_do_not_import_jax():
    pattern = re.compile(r'^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|basicsr4rs_tpu)\b',
                         re.MULTILINE)
    offenders = [str(p.relative_to(ROOT)) for p in (ROOT / 'basicsr4rs_torch').rglob('*.py')
                 if pattern.search(p.read_text())]
    offenders += [name for name in ('chip_smoke.py',)
                  if (ROOT / name).exists() and pattern.search((ROOT / name).read_text())]
    assert not offenders
