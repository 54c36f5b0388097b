"""Structured logging — the logrus/zap role in the reference.

The reference daemon logs every RPC through logrus request/response
interceptors (reference daemon/kubedtn/kubedtn.go:175-189) and tags each
link operation with per-action fields (reference common/context.go:11-29:
WithField("daemon"/"overlay"/"action")); the controller side uses zap via
controller-runtime (reference main.go:61-78). Here the same story is the
stdlib `logging` module with a logrus-style key=value text formatter, a
gRPC server interceptor, and field-tagged loggers used by the engine and
reconciler.

Level comes from KUBEDTN_LOG_LEVEL (the daemon honors it at startup);
libraries only ever call `get_logger` — handlers/levels are the
application's (cli.py's) choice, so importing this module never
configures global logging state.
"""

from __future__ import annotations

import logging
import os
import time

ROOT = "kubedtn"


def get_logger(name: str) -> logging.Logger:
    """Namespaced logger: get_logger("engine") → "kubedtn.engine"."""
    return logging.getLogger(f"{ROOT}.{name}")


def fields(**kv) -> str:
    """Render key=value fields logrus-text style: values with spaces,
    quotes, or newlines are double-quoted with escaping — newlines are
    escaped so one record can never split into (or forge) a second log
    line."""
    parts = []
    for k, v in kv.items():
        s = str(v)
        if any(c in s for c in ' "=\n\r') or s == "":
            s = (s.replace('\\', '\\\\').replace('"', '\\"')
                  .replace("\n", "\\n").replace("\r", "\\r"))
            s = f'"{s}"'
        parts.append(f"{k}={s}")
    return " ".join(parts)


class KVFormatter(logging.Formatter):
    """logrus text-format lookalike:
    time="..." level=info msg="..." logger=kubedtn.engine"""

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S",
                           time.localtime(record.created))
        msg = record.getMessage()
        head = fields(time=f"{ts}.{int(record.msecs):03d}",
                      level=record.levelname.lower(), msg=msg)
        out = f'{head} logger={record.name}'
        if record.exc_info:
            out += "\n" + self.formatException(record.exc_info)
        return out


def setup(level: str | None = None, stream=None,
          logfile: str | None = None) -> logging.Logger:
    """Configure the kubedtn logger tree (idempotent). Level defaults to
    $KUBEDTN_LOG_LEVEL then "info"."""
    level = (level or os.environ.get("KUBEDTN_LOG_LEVEL", "info")).upper()
    root = logging.getLogger(ROOT)
    root.setLevel(getattr(logging, level, logging.INFO))
    root.propagate = False
    # replace our own handlers only (idempotent across restarts/tests)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler(stream)
    handler.setFormatter(KVFormatter())
    root.addHandler(handler)
    if logfile:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(KVFormatter())
        root.addHandler(fh)
    return root


class _GrpcLoggingInterceptor:
    """Server interceptor logging one line per RPC — method, outcome,
    duration — the role of the reference's logrus request/response
    interceptors (kubedtn.go:175-189). Failures (handler exceptions or
    context aborts) log at warning with the exception type."""

    def __init__(self, logger: logging.Logger | None = None) -> None:
        self.log = logger or get_logger("grpc")

    def intercept_service(self, continuation, handler_call_details):
        import grpc

        handler = continuation(handler_call_details)
        if handler is None:
            return None
        method = handler_call_details.method
        log = self.log
        # per-FRAME RPCs (WireProtocol) log at debug — success AND failure:
        # at kpps rates a line per frame (e.g. NOT_FOUND for a torn-down
        # wire while the peer keeps forwarding) would throttle forwarding
        # and flood logs. Control-plane RPCs keep info/warning (the
        # reference interceptor's levels); frame errors stay countable via
        # daemon.forward_errors.
        service = method.rsplit("/", 2)[-2] if "/" in method else ""
        per_frame = service.endswith("WireProtocol")
        ok_level = logging.DEBUG if per_frame else logging.INFO
        err_level = logging.DEBUG if per_frame else logging.WARNING

        def error_name(context, e) -> str:
            # context.abort() raises a bare Exception; the status the
            # handler set is the useful name (e.g. NOT_FOUND)
            try:
                code = context.code()
                if code is not None:
                    return getattr(code, "name", str(code))
            except Exception:
                pass
            return type(e).__name__

        def wrap_call(fn):
            # one wrapper serves unary_unary AND stream_unary: both take
            # (request-or-iterator, context) and return one response
            def wrapped(request, context):
                t0 = time.perf_counter()
                try:
                    resp = fn(request, context)
                except Exception as e:
                    if log.isEnabledFor(err_level):
                        log.log(err_level, "rpc failed %s", fields(
                            method=method, error=error_name(context, e),
                            ms=round((time.perf_counter() - t0) * 1e3, 2)))
                    raise
                if log.isEnabledFor(ok_level):  # skip fields() when muted
                    log.log(ok_level, "rpc %s", fields(
                        method=method, code="OK",
                        ms=round((time.perf_counter() - t0) * 1e3, 2)))
                return resp
            return wrapped

        def wrap_stream_out(fn):
            def wrapped(request, context):
                t0 = time.perf_counter()
                try:
                    yield from fn(request, context)
                    if log.isEnabledFor(ok_level):
                        log.log(ok_level, "rpc %s", fields(
                            method=method, code="OK", streamed=True,
                            ms=round((time.perf_counter() - t0) * 1e3, 2)))
                except Exception as e:
                    if log.isEnabledFor(err_level):
                        log.log(err_level, "rpc failed %s", fields(
                            method=method, error=error_name(context, e),
                            ms=round((time.perf_counter() - t0) * 1e3, 2)))
                    raise
            return wrapped

        if handler.unary_unary:
            return grpc.unary_unary_rpc_method_handler(
                wrap_call(handler.unary_unary),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)
        if handler.stream_unary:
            return grpc.stream_unary_rpc_method_handler(
                wrap_call(handler.stream_unary),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)
        if handler.unary_stream:
            return grpc.unary_stream_rpc_method_handler(
                wrap_stream_out(handler.unary_stream),
                request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)
        return handler  # stream_stream: none in the wire protocol


_INTERCEPTOR_CLS = None


def GrpcLoggingInterceptor(logger: logging.Logger | None = None):
    """A per-RPC logging interceptor: `_GrpcLoggingInterceptor` mixed
    with grpc.ServerInterceptor. Built on first use, so importing this
    module never imports grpc."""
    global _INTERCEPTOR_CLS
    if _INTERCEPTOR_CLS is None:
        import grpc

        _INTERCEPTOR_CLS = type("GrpcLoggingInterceptor",
                                (_GrpcLoggingInterceptor,
                                 grpc.ServerInterceptor), {})
    return _INTERCEPTOR_CLS(logger)
