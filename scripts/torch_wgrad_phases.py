"""Where the sparse weight gradient's time goes, block by block, on one card.

    python3 scripts/torch_wgrad_phases.py     # on the machine with the card

Captures the 14 `sparse_wgrad` calls of one SECOND car.fhd train step (the
batch, weights and voxel capacity of chip_smoke.py's train phase), builds
an instrumented copy of second_tpu_torch/csrc/subm_grad.cu (probes of
%globaltimer and clock64 by thread 0 of each block, inserted at fixed
places of the source; the script stops if one is missing) into
second_tpu_torch/_build/, and runs calls 0, 1, 5, 9 and 12 through it after
an L2 flush. Prints per call: the span from the first block's start to the
last sum's end, when the last block started and when the last block's own
work, the last group sum and the last tap sum ended; the blocks' work
time and found rows (median, 90th percentile, largest); the median block's
and the heaviest block's scan, tap_idx and tile phases; and the blocks'
work summed over three blocks an SM, the span a perfect balance would give.
Phase times are clock64 cycles at 1.98 GHz, the card's highest SM clock.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from second_tpu_torch.config import load_pipeline_config  # noqa: E402
from second_tpu_torch.ops.cuda import BUILD_DIR, _nvcc, subm  # noqa: E402
from second_tpu_torch.ops.voxelize import VoxelizeSpec  # noqa: E402
from second_tpu_torch.train.state import make_train_step  # noqa: E402

src = (ROOT / "second_tpu_torch/csrc/subm_grad.cu").read_text()
hdr = r'''
__device__ long long* g_prof;
__device__ __forceinline__ long long gtime() { long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }
__device__ __forceinline__ int smid() { int s; asm volatile("mov.u32 %0, %%smid;" : "=r"(s)); return s; }
#define SLOT(i) g_prof[((long long)blockIdx.y * gridDim.x + blockIdx.x) * 16 + (i)]
#define PROBE(i) if (threadIdx.x == 0 && g_prof) SLOT(i) = clock64();
#define PROBE_T(i) if (threadIdx.x == 0 && g_prof) SLOT(i) = gtime();
#define PROBE_V(i, v) if (threadIdx.x == 0 && g_prof) SLOT(i) = (v);
#define PROBE_ADD(i, v) if (threadIdx.x == 0 && g_prof) SLOT(i) += (v);
'''
def patch(s, old, new):
    assert old in s, old
    return s.replace(old, new, 1)
s = patch(src, "namespace {\n", "namespace {\n" + hdr)
s = patch(s, "  P path;\n", "  PROBE_T(8) PROBE(0) PROBE_V(10, smid())\n  int ntot = 0, npass = 0; long long tscan = 0, ttap = 0, ttile = 0, c0 = clock64();\n  P path;\n")
s = patch(s, "    if (n == 0) continue;\n", "    tscan += clock64() - c0; c0 = clock64();\n    if (n == 0) continue;\n    ++npass; ntot += n;\n")
s = patch(s, "    const int tiles = (n + TILE - 1) / TILE;\n", "    ttap += clock64() - c0; c0 = clock64();\n    const int tiles = (n + TILE - 1) / TILE;\n")
s = patch(s, "    cp_async_wait<0>();\n    __syncthreads();                      // the lists and the ring are free\n  }\n",
          "    cp_async_wait<0>();\n    __syncthreads();                      // the lists and the ring are free\n    ttile += clock64() - c0; c0 = clock64();\n  }\n")
s = patch(s, "  const int CD = a.C * a.D;\n  if (chunks == 1)", "  PROBE(3) PROBE_T(9) PROBE_V(11, npass) PROBE_V(12, ntot) PROBE_V(1, tscan) PROBE_V(2, ttap) PROBE_V(4, ttile)\n  const int CD = a.C * a.D;\n  if (chunks == 1)")
s = patch(s, "  if (tid == 0) tickets[g] = 0;           // ready for the next call\n", "  if (tid == 0) tickets[g] = 0;           // ready for the next call\n  PROBE_T(13)\n")
s = patch(s, "  if (tid == 0) tickets[groups] = 0;\n", "  if (tid == 0) tickets[groups] = 0;\n  PROBE_T(14)\n")
s += '\nextern "C" int set_prof(void* p) { return (int)cudaMemcpyToSymbol(g_prof, &p, sizeof(p)); }\n'
BUILD_DIR.mkdir(exist_ok=True)
cu = BUILD_DIR / "wgrad_phases.cu"
cu.write_text(s)
lib = BUILD_DIR / "libwgrad_phases.so"
r = subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(cu)], capture_output=True, text=True)
if r.returncode: print(r.stdout, r.stderr); sys.exit(1)
L = ctypes.CDLL(str(lib)); fn = L.subm_wgrad; fn.argtypes = subm._WGRAD_ARGTYPES; fn.restype = ctypes.c_int
L.set_prof.argtypes = [ctypes.c_void_p]
dev = torch.device("cuda", 0)
torch.backends.cudnn.deterministic = True
cfg = load_pipeline_config(cs.CONFIG)
state, spec, info, assigner = cs.new_train_state(cfg, dev, True)
vspec = VoxelizeSpec.from_config(cfg.model.voxel_generator, cs.TRAIN_VOXELS, shuffle_overflow=True)
batch = cs.train_inputs(cfg, assigner, info, dev, cs.TRAIN_BATCH)
with cs.recording(cs.RECORDED_TRAIN) as calls:
    make_train_step(spec, vspec)(state, batch); torch.cuda.synchronize()
wc = [a for a, _ in calls["sparse_wgrad"]]
sms = torch.cuda.get_device_properties(dev).multi_processor_count
flush = torch.empty(64 << 20, dtype=torch.int16, device=dev)
GHZ = 1.98
for i in (0, 1, 5, 9, 12):
    feats, tap_idx, found, dout = wc[i]
    B, N, C = feats.shape; _, K, Q = tap_idx.shape; D = dout.shape[2]
    M = B * Q
    chunk_rows, chunks = subm.wgrad_chunks(M, K, sms)
    groups = -(-chunks // subm.WGRAD_GROUP)
    partial = torch.empty((K, chunks, C, D), dtype=torch.float32, device=dev)
    used = torch.empty((K, chunks), dtype=torch.int32, device=dev)
    gp = torch.empty((K, groups, C, D), dtype=torch.float32, device=dev)
    gu = torch.empty((K, groups), dtype=torch.int32, device=dev)
    dw = torch.empty((K, C, D), dtype=torch.float32, device=dev)
    args = [t.contiguous() for t in (feats, tap_idx.int(), found, dout)]
    prof = torch.zeros(K * chunks * 16, dtype=torch.int64, device=dev)
    def go(p=None):
        L.set_prof(p.data_ptr() if p is not None else None)
        assert fn(1, args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(), args[3].data_ptr(), partial.data_ptr(), used.data_ptr(), gp.data_ptr(), gu.data_ptr(), subm._counters(dev, K * (groups + 1)).data_ptr(), dw.data_ptr(), B, N, Q, K, C, D, chunk_rows, chunks, torch.cuda.current_stream().cuda_stream) == 0
    go(); flush.fill_(1); go(prof); torch.cuda.synchronize(); L.set_prof(None)
    p = prof.view(K * chunks, 16).cpu()
    t0 = p[:, 8].min().item()
    start = (p[:, 8] - t0).double() / 1e3; work_end = (p[:, 9] - t0).double() / 1e3
    gend = torch.where(p[:, 13] > 0, (p[:, 13] - t0).double() / 1e3, torch.zeros(1, dtype=torch.float64))
    tend = torch.where(p[:, 14] > 0, (p[:, 14] - t0).double() / 1e3, torch.zeros(1, dtype=torch.float64))
    nf = p[:, 12].double(); us = lambda j: p[:, j].double() / GHZ / 1e3
    dur = work_end - start
    print(f"call {i}: {C}->{D} K {K} M {M} chunks {chunks} x {chunk_rows} groups {groups}; blocks {K*chunks}")
    print(f"  span {max(work_end.max(), gend.max(), tend.max()):.1f} us; last block start {start.max():.1f}; last work end {work_end.max():.1f}; last group sum end {gend.max():.1f}; last tap sum end {tend.max():.1f}")
    print(f"  block work us p10/50/90/max {dur.quantile(0.1):.1f} {dur.median():.1f} {dur.quantile(0.9):.1f} {dur.max():.1f}; found p50 {nf.median():.0f} max {nf.max():.0f}; passes max {p[:,11].max().item()}")
    print(f"  phase sums per block p50 us: scan {us(1).median():.2f} tap {us(2).median():.2f} tiles {us(4).median():.2f}; heaviest block: scan {us(1)[nf.argmax()]:.2f} tap {us(2)[nf.argmax()]:.2f} tiles {us(4)[nf.argmax()]:.2f} ({nf.max():.0f} rows, {us(4)[nf.argmax()]/max(nf.max()/64,1):.3f} us/tile)")
    busy = dur.sum() / (3 * sms)
    print(f"  sum of block work / (3 x SMs) = {busy:.1f} us")
