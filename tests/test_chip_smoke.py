"""chip_smoke.py refuses to report a result without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_fails_without_gpu_and_prints_no_result(where, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":  # a directory holding the script and nothing else
        shutil.copy(script, tmp_path)
        script, cwd = os.path.join(tmp_path, "chip_smoke.py"), str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        assert not (isinstance(obj, dict) and "ok" in obj), line
