from gridllm_torch.bus.base import MessageBus, Subscription
from gridllm_torch.bus.memory import InMemoryBus


def _parse_endpoint(ep: str) -> tuple[str, int]:
    """``resp://host:port`` / ``redis://…`` / bare ``host:port`` → (host,
    port). Bare entries keep GRIDLLM_BUS_ENDPOINTS copy-pasteable."""
    from urllib.parse import urlparse

    if "//" not in ep:
        ep = "resp://" + ep
    parsed = urlparse(ep)
    return parsed.hostname or "localhost", parsed.port or 6379


def create_bus(url: str = "", key_prefix: str = "GridLLM:",
               password: str | None = None, db: int = 0,
               endpoints: list[str] | None = None) -> MessageBus:
    """Bus factory. "" → process-local in-memory bus; "resp://host:port" or a
    standard "redis://[:pass@]host:port[/db]" URL → RESP wire protocol (real
    Redis or the bundled gridbus broker). Explicit password/db args are
    fallbacks for URL forms that omit them.

    ``endpoints`` (from GRIDLLM_BUS_ENDPOINTS) is the ordered
    broker list for warm-standby failover — primary FIRST; when set it
    defines where the RespBus connects (url still picks the protocol and
    supplies credentials). The url itself may also carry a comma list:
    ``resp://h1:p1,h2:p2``.
    """
    if not url and endpoints:
        url = "resp://" + endpoints[0].split("//")[-1]
    if not url or url == "memory://":
        return InMemoryBus(key_prefix=key_prefix)
    if url.startswith(("resp://", "redis://", "rediss://")):
        from urllib.parse import urlparse

        from gridllm_torch.bus.resp import RespBus

        scheme, _, rest = url.partition("//")
        url_eps = [e for e in rest.split(",") if e]
        parsed = urlparse(scheme + "//" + url_eps[0])
        url_db = parsed.path.lstrip("/")
        eps = [_parse_endpoint(e) for e in (endpoints or url_eps)]
        return RespBus(
            host=eps[0][0],
            port=eps[0][1],
            key_prefix=key_prefix,
            password=parsed.password or password,
            db=int(url_db) if url_db.isdigit() else db,
            endpoints=eps,
        )
    raise ValueError(f"Unknown bus url: {url!r}")


__all__ = ["MessageBus", "Subscription", "InMemoryBus", "create_bus"]
