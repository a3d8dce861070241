"""rtmp_relay — a live RTMP relay server (publish -> play) with an FLV
dump: one port takes RTMP publishers and players and still answers every
other protocol beside them; the media a publisher pushes is relayed live,
muxed into FLV and into an MPEG-TS segment, and a second server pulls the
stream over the digest handshake and serves its own player (the edge).

Port of examples/rtmp_relay.py:

  python -m brpc_tpu_torch.examples.rtmp_relay [--device cpu]
"""
import argparse
import io
import struct
import sys
import time

from brpc_tpu_torch import rpc
from brpc_tpu_torch.rpc import amf, flv, mpegts
from brpc_tpu_torch.rpc import rtmp_client as rclient
from brpc_tpu_torch.rpc import rtmp_protocol as rtmp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    srv = rpc.Server(rpc.ServerOptions(num_threads=4, device=args.device,
                                       rtmp_service=rtmp.RtmpService()))
    assert srv.start("127.0.0.1:0") == 0
    port = srv.listen_endpoint.port
    print(f"rtmp server on rtmp://127.0.0.1:{port}/live")

    # in-process publisher + player on the public client-session API
    # (a stand-in for OBS + a video player)
    pconn, pub = rtmp.rtmp_client_connect("127.0.0.1", port)
    pub.send_command("createStream", 2.0, None)
    pub.send_command("publish", 3.0, None, "demo", "live", stream_id=1)
    pub.pump(want=2)

    vconn, ply = rtmp.rtmp_client_connect("127.0.0.1", port)
    ply.send_command("createStream", 2.0, None)
    ply.send_command("play", 4.0, None, "demo", stream_id=1)
    ply.pump(want=1)
    ply.inbox.clear()

    # publish a tiny synthetic stream
    pub.send_message(rtmp.MSG_DATA_AMF0, 0,
                     amf.encode_many("onMetaData",
                                     {"width": 64.0, "height": 48.0}),
                     stream_id=1)
    for i in range(5):
        payload = b"\x27\x01" + struct.pack(">I", i) + b"frame" * 20
        pub.send_message(rtmp.MSG_VIDEO, i * 33, payload, stream_id=1)

    ply.pump_until(
        lambda s: sum(1 for t, _, _ in s.inbox
                      if t == rtmp.MSG_VIDEO) >= 5)
    out = io.BytesIO()
    w = flv.FlvWriter(out, has_audio=False)
    frames = 0
    for msg_type, ts, payload in ply.inbox:
        if msg_type == rtmp.MSG_VIDEO:
            w.write_video(ts, payload)
            frames += 1
        elif msg_type == rtmp.MSG_DATA_AMF0:
            w.write_metadata(ts, payload)
    tags = list(flv.read_tags(out.getvalue()))
    print(f"relayed {frames} video frames; FLV dump = {len(out.getvalue())}"
          f" bytes, {len(tags)} tags")
    assert frames >= 5, "relay dropped frames"

    # ...and the same payloads packetize into an HLS-style TS segment
    ts = mpegts.TsMuxer(has_audio=False)
    for msg_type, t, payload in ply.inbox:
        if msg_type == rtmp.MSG_VIDEO:
            ts.write_video(t, payload)
    seg = ts.packets()
    demuxed = sum(1 for _ in mpegts.demux(seg))
    print(f"TS segment = {len(seg) // mpegts.TS_PACKET} packets, "
          f"{demuxed} PES demuxed")

    # edge-pull topology: a SECOND relay server pulls "demo" from the
    # first over the digest-handshake RtmpClient and serves its own
    # players — the CDN-edge shape (rtmp.h RtmpClient/RtmpClientStream)
    edge_svc = rtmp.RtmpService()
    edge = rpc.Server(rpc.ServerOptions(num_threads=4, device=args.device,
                                        rtmp_service=edge_svc))
    assert edge.start("127.0.0.1:0") == 0
    puller = rclient.pull_into_service(edge_svc, "demo",
                                       "127.0.0.1", port)
    got = []

    def on_edge_media(msg_type, ts_ms, payload):
        if msg_type == rtmp.MSG_VIDEO:
            got.append(payload)

    edge_player = rclient.RtmpClient(
        "127.0.0.1", edge.listen_endpoint.port).connect()
    assert edge_player.digest_mode  # the digest handshake was used
    edge_player.start_reader()
    edge_player.create_stream().play("demo", on_edge_media)
    deadline = time.monotonic() + 10
    while len(got) < 3 and time.monotonic() < deadline:
        pub.send_message(rtmp.MSG_VIDEO, 999, b"\x27edgeframe",
                         stream_id=1)
        time.sleep(0.1)
    assert len(got) >= 3, "edge pull relayed nothing"
    print(f"edge server relayed {len(got)} frames pulled from the origin "
          f"(digest handshake)")
    edge_player.close()
    puller.close()
    edge.stop()

    pconn.close()
    vconn.close()
    time.sleep(0.1)
    srv.stop()
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
