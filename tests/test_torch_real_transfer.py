"""The port's xfer lane over real CUDA IPC between two processes on one card
(the twin of tests/test_real_transfer.py, without the fake fabric).

It needs an NVIDIA card and nvcc (the IPC calls are built at first use),
so it skips where CUDA is unavailable. On the card, from the repo root:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_real_transfer.py

(``--noconftest``: the root conftest configures JAX, which a card machine
need not have; this file imports none of it.)
"""
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

XFER_SERVER_SCRIPT = r"""
import sys
sys.path.insert(0, ".")
from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc.tensor_service import TensorStoreService

srv = rpc.Server(rpc.ServerOptions())  # on the card
srv.add_service(TensorStoreService())
assert srv.start("127.0.0.1:0") == 0
print(srv.listen_endpoint.port, flush=True)
sys.stdin.readline()
srv.stop()
"""


@pytest.mark.gpu
def test_two_process_cuda_ipc_push_pull():
    """Publish on this process's CUDA IPC server, the peer pulls device to
    device, zero payload bytes on the RPC wire; the pull comes back the
    same way, onto the card, byte-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA is not available")
    from brpc_tpu_torch.butil import flags
    from brpc_tpu_torch.rpc import device_transport as dt
    from brpc_tpu_torch.rpc.tensor_service import (
        TensorClient,
        make_device_channel,
    )

    dt.default_send_arena()  # not the lane under test, but created first
    env = dict(os.environ, BRPC_TPU_DEVICE_TRANSPORT_PREFER_XFER="1")
    env.pop("BRPC_TPU_FAKE_XFER", None)
    env.pop("PYTORCH_CUDA_ALLOC_CONF", None)  # IPC needs the default allocator
    proc = subprocess.Popen([sys.executable, "-c", XFER_SERVER_SCRIPT],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True, cwd=REPO, env=env)
    flags.set_flag("device_transport_prefer_xfer", True)
    ch = None
    try:
        port = int(proc.stdout.readline())
        ch = make_device_channel(f"127.0.0.1:{port}")
        client = TensorClient(ch)
        x = torch.arange(4096, dtype=torch.float32, device="cuda").reshape(
            64, 64) * 0.5
        xfer0 = dt.lane_counters()["xfer"]
        cntl, resp = client.push("real-xw", [x])
        assert not cntl.failed(), cntl.error_text
        assert resp.ok
        assert dt.lane_counters()["xfer"] == xfer0 + 1
        assert len(cntl.request_attachment) == 0  # bytes rode CUDA IPC
        ep = cntl._current_sock.app_state
        assert ep.retained_count == 0 and ep.inflight_bytes == 0
        assert dt._global_xfer_server().published_count() == 0

        cntl, pulled = client.pull("real-xw", device="cuda")
        assert not cntl.failed(), cntl.error_text
        assert cntl._response_rpc_meta.tensors[0].sharding_spec.startswith(
            "xfer|127.0.0.1:")
        assert pulled[0].device.type == "cuda"
        assert torch.equal(pulled[0], x)
    finally:
        flags.set_flag("device_transport_prefer_xfer", False)
        if ch is not None:
            ch.close()
        proc.stdin.close()
        proc.wait(timeout=30)
