"""Small copies of the benchmark's cells for the CPU tests: the real
``BENCHMARK.json`` with each configuration cut to ``m=9``,
``coarse_size=20`` (three levels), written under a temporary root."""
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {"m": 9, "coarse_size": 20}


def small_root(tmp: Path) -> Path:
    """A root holding ``BENCHMARK.json`` and every configuration file,
    each cut to ``SMALL``; the harness's own files stay where they are."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for conf in manifest["configs"]:
        cfg = json.loads((ROOT / conf["file"]).read_text())
        cfg["elasticity"].update(SMALL)
        dst = tmp / conf["file"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(json.dumps(cfg))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return tmp
