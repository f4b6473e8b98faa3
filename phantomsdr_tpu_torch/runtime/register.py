"""Directory-registration client.

Equivalent of the reference's registration heartbeat thread (reference:
src/register.cpp:8-51): every 60 s POST a JSON body to
``https://phantomsdr.duckdns.org/api/v1/ping`` describing this server
so it appears on the public list.  Field set mirrors the registration
struct (src/spectrumserver.h:141-156); ``users`` is the number of live
/events connections (src/register.cpp:14).

Failures are logged and retried on the next tick (the reference
swallows them the same way).  Disabled unless ``[register] enable``.
"""

from __future__ import annotations

import asyncio
import logging

import aiohttp

from ..config import ServerConfig

REGISTRY_URL = "https://phantomsdr.duckdns.org/api/v1/ping"
INTERVAL_S = 60.0

log = logging.getLogger("phantomsdr.register")


def registration_body(cfg: ServerConfig, users: int) -> dict:
    body = {
        "password": cfg.register_password,
        "name": cfg.register_name,
        "hardware": cfg.register_hardware,
        "antenna": cfg.register_antenna,
        "bandwidth": float(cfg.total_bandwidth),
        "users": users,
        "remarks": "",
        "description": cfg.register_description,
        "base_frequency": float(cfg.basefreq),
        "https": False,
        "port": cfg.port,
    }
    if cfg.register_url:
        body["url"] = cfg.register_url
    return body


async def registration_task(cfg: ServerConfig, user_count_fn) -> None:
    """Run forever; call with asyncio.create_task when register.enable."""
    async with aiohttp.ClientSession(
        headers={"User-Agent": "PhantomSDR server"}
    ) as session:
        while True:
            try:
                body = registration_body(cfg, user_count_fn())
                async with session.post(
                    REGISTRY_URL, json=body,
                    timeout=aiohttp.ClientTimeout(total=20),
                ) as resp:
                    await resp.read()
            except Exception as e:  # log-and-retry, src/register.cpp:44-48
                log.warning("Error registering server: %s", e)
            await asyncio.sleep(INTERVAL_S)
