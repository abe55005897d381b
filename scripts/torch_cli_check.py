"""The CLIs of serving and detector-driven tracking on the card: a 2-step
Trainer checkpoint served by `python -m second_tpu_torch.serve` (/healthz,
/v1/detect JSON and octet-stream, /stats), the viewer backend's
build_network + inference_points, `run_tracking train/evaluate
--detector_config --detector_dir` and `run_tracking train --with_detector`
from a temporal Trainer checkpoint.

    python3 scripts/torch_cli_check.py     # from the repository root

Each command runs as a user starts it, on the card; a failing command
ends the script with its exit code."""
import json
import socket
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path.cwd()))
from second_tpu_torch.data import lidar_scan_scene  # noqa: E402

CFG = "second_tpu_torch/configs/second_car_fhd.config"
tmp = Path(tempfile.mkdtemp())


def run(*args):
    print("$", " ".join(args), flush=True)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                         text=True)
    print(out.stdout[-1500:], out.stderr[-1500:], flush=True)
    print(f"exit {out.returncode} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if out.returncode:
        sys.exit(out.returncode)


def port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def call(url, data=None, ctype="application/json"):
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": ctype} if data is not None else {})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def wait(url, proc):
    for _ in range(600):
        if proc.poll() is not None:
            sys.exit(f"server exited {proc.returncode}")
        try:
            return call(url)
        except OSError:
            time.sleep(0.5)
    sys.exit("server did not answer")


run("second_tpu_torch.train.run", "train", "--config_path", CFG,
    "--model_dir", str(tmp / "m"), "--synthetic", "--steps", "2",
    "--dataset_size", "8", "--patchs", "train_config.steps_per_eval=0")
pts = lidar_scan_scene(np.random.default_rng(5), pc_range=(
    0, -40, -3, 70.4, 40, 1), num_azimuth=512)[0].astype(np.float32)
p = port()
srv = subprocess.Popen([sys.executable, "-m", "second_tpu_torch.serve",
                        "--config_path", CFG, "--model_dir",
                        str(tmp / "m"), "--port", str(p), "--max_points",
                        "30000"])
try:
    print("healthz", wait(f"http://127.0.0.1:{p}/healthz", srv), flush=True)
    code, out = call(f"http://127.0.0.1:{p}/v1/detect", json.dumps(
        {"points": pts[:4000].round(3).tolist()}).encode())
    print("detect json", code, out["status"], out["num_detections"],
          out["scores"][:3], flush=True)
    code, out = call(f"http://127.0.0.1:{p}/v1/detect", pts.tobytes(),
                     "application/octet-stream")
    print("detect octet-stream", code, out["status"],
          out["num_detections"], flush=True)
    print("stats", call(f"http://127.0.0.1:{p}/stats"), flush=True)
finally:
    srv.terminate()
    srv.wait()
p = port()
view = subprocess.Popen([sys.executable, "-m",
                         "second_tpu_torch.viewer.backend", "--port",
                         str(p)])
try:
    url = f"http://127.0.0.1:{p}"
    for _ in range(600):
        try:
            urllib.request.urlopen(url + "/", timeout=5).read()
            break
        except OSError:
            time.sleep(0.5)
    print("viewer build_network", call(url + "/api/build_network", json.dumps(
        {"config_path": CFG, "model_dir": str(tmp / "m")}).encode()),
        flush=True)
    code, out = call(url + "/api/inference_points", json.dumps(
        {"points": pts[:4000].round(3).tolist()}).encode())
    print("viewer inference_points", code, out["status"],
          len(out["dt_boxes"]), flush=True)
finally:
    view.terminate()
    view.wait()
run("second_tpu_torch.train.run_tracking", "train", "--model_dir",
    str(tmp / "trk"), "--steps", "3", "--detector_config", CFG,
    "--detector_dir", str(tmp / "m"))
run("second_tpu_torch.train.run_tracking", "evaluate", "--model_dir",
    str(tmp / "trk"), "--num_sequences", "2", "--detector_config", CFG,
    "--detector_dir", str(tmp / "m"))
run("second_tpu_torch.train.run", "train", "--model_type", "temporal",
    "--config_path", CFG, "--model_dir", str(tmp / "tm"), "--synthetic",
    "--steps", "1", "--dataset_size", "8", "--patchs",
    "train_config.steps_per_eval=0")
run("second_tpu_torch.train.run_tracking", "train", "--with_detector",
    "--detector_config", CFG, "--detector_dir", str(tmp / "tm"),
    "--model_dir", str(tmp / "j"), "--steps", "3")
print("CLI CHECK DONE", flush=True)
