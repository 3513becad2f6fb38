"""Minimal live-view GUI front-end (stdlib HTTP server + browser page).

The reference ships a 25-kLoC ImGui desktop app (src/gui/) whose hard
architectural rule is "front-ends may only use the public API"
(scripts/check_policies.py check 3). This package keeps that boundary with
a far smaller footprint: a dependency-free web front-end over
ice_halo_sim_jax.engine.server.Server — live image polling (the GUI's
server_poller loop), display-time exposure control (gui_ev_auto
semantics), and config re-commit with the appearance-vs-layout split
deciding whether accumulation restarts.
"""

from ice_halo_sim_jax.gui.app import serve  # noqa: F401
