"""The geometric pipelines import with nothing beyond jax, numpy and scipy."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCKED = ("flax", "orbax", "cv2", "matplotlib")


def test_main_path_imports_without_optional_packages():
    # A None entry in sys.modules makes `import name` raise ImportError.
    code = "\n".join([
        "import sys",
        *(f"sys.modules[{name!r}] = None" for name in BLOCKED),
        "import perception.models.cuboid",
        "import perception.models.slam.system",
        "import perception.models.object_tracking",
        f"leaked = [m for m in sys.modules if m.split('.')[0] in {BLOCKED!r} "
        "and sys.modules[m] is not None]",
        "assert not leaked, leaked",
        "print('imports ok')",
    ])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "imports ok" in out.stdout
