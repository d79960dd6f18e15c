"""The service tier (counterpart of ``ratelimiter_tpu/service/``): the
properties, the wiring and the HTTP demo API."""

from ratelimiter_tpu_torch.service.app import make_server, serve_forever
from ratelimiter_tpu_torch.service.props import AppProperties
from ratelimiter_tpu_torch.service.wiring import AppContext, build_app

__all__ = ["make_server", "serve_forever", "AppProperties", "AppContext",
           "build_app"]
