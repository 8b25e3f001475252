"""Host milliseconds a clip inside ``StreamingSR``: the span ``stream.run``
less the waits on the device inside it (``stream.upload_wait``,
``stream.fetch_wait``) and the caller's ``on_chunk`` (``stream.deliver``)."""

from portbench.harness import spans


def read(ctx):
    return spans.self_ms("stream.run", lambda n: n.endswith("_wait") or n == "stream.deliver")
