"""native_client — the native client's features: a sync call, an async
done-callback, a deadline, and a connection revived after its server
came back (the brpc Controller's timeouts and health-check revival, on
the native C++ runtime through ctypes).

Port of examples/native_client.py:

  python -m brpc_tpu_torch.examples.native_client

The server is the native runtime's own echo; no card is involved. Where
the native library does not build this raises ``NativeUnavailable`` with
the compiler's errors (queue C #39: the reference prints that there is
nothing to demo and exits 0).
"""
import sys
import threading
import time

from brpc_tpu_torch import native


def main(argv=None) -> int:
    native.load()  # raises NativeUnavailable with the compiler's errors
    port = native.rpc_server_start(native_echo=True)
    print(f"native server on 127.0.0.1:{port}")
    ch = native.channel_open("127.0.0.1", port, connect_timeout_ms=2000,
                             health_check_ms=50)
    try:
        # 1. a sync call with a generous deadline
        rc, body, err = native.channel_call(ch, "EchoService", "Echo",
                                            b"hello-native", timeout_ms=2000)
        assert rc == 0 and body == b"hello-native", (rc, err)
        print("sync echo:", body.decode())

        # 2. an async done-callback
        done_evt = threading.Event()

        def done(code, resp):
            print(f"async done: code={code} resp={resp.decode()}")
            done_evt.set()

        assert native.channel_acall(ch, "EchoService", "Echo", b"async-hi",
                                    done, timeout_ms=2000) == 0
        assert done_evt.wait(5)

        # 3. a deadline on a stalled method: no handler, and nothing
        # drains the Python lane, so the request waits until the native
        # timer fails the call (ERPCTIMEDOUT, 1008) after 150 ms
        t0 = time.monotonic()
        rc, _, err = native.channel_call(ch, "NoSuch", "Stall", b"x",
                                         timeout_ms=150)
        dt_ms = (time.monotonic() - t0) * 1000
        print(f"deadline: rc={rc} ({err}) after {dt_ms:.0f}ms")
        assert rc == 1008

        # 4. kill and revive: calls fail while the server is down, and the
        # channel dials again on demand once it is back on the same port
        native.rpc_server_stop()
        rc, _, _ = native.channel_call(ch, "EchoService", "Echo", b"down",
                                       timeout_ms=300)
        print(f"server down: rc={rc}")
        assert rc != 0
        assert native.rpc_server_start(port=port, native_echo=True) == port
        deadline = time.monotonic() + 10
        rc = -1
        while time.monotonic() < deadline:
            rc, body, _ = native.channel_call(ch, "EchoService", "Echo",
                                              b"revived", timeout_ms=1000)
            if rc == 0:
                break
            time.sleep(0.05)
        assert rc == 0 and body == b"revived"
        print("revived:", body.decode())
    finally:
        native.channel_close(ch)
        native.rpc_server_stop()
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
