"""Async render server: commit/poll lifecycle over the Engine.

Counterpart of the reference server layer
(/root/reference/src/server/server.cpp). The reference runs N simulator
worker threads + a scene-generator thread + a consumer thread joined by
blocking queues; here one jitted step IS the whole pipeline, so the server
reduces to a single pump thread feeding batches to the device plus a
commit/snapshot protocol. What is preserved is the *semantics*:

  - ``commit()`` with a value-equal config reuses the accumulated image
    (Server::CommitConfig reuse predicate, server.cpp:530 +
    config_compare.hpp); an appearance-only render change (background,
    ray_color, intensity_factor, grid...) keeps accumulators and re-tone-maps
    (RenderConfig::NeedsRebuild layout-vs-appearance split,
    render_config.hpp:71-111); anything else resets and bumps the
    generation.
  - Stale work cannot leak across generations: the pump thread holds the
    engine lock for exactly one batch, and commit swaps the engine under the
    same lock (the reference's generation-tagged batch discard,
    server.cpp:1229).
  - ``acquire_frame()`` returns an immutable snapshot tagged with
    ``snapshot_generation`` — the only sameness test (ResultFrame,
    server.hpp:229-242).
  - Lifecycle: ``state()`` reports RUNNING while committed work remains,
    IDLE when the ray budget is drained (the 6-term idle predicate collapses
    to two terms here because there are no queues, server.cpp:1018-1128).
  - ``sim_ray_count()`` is O(1) and render-free (stats.hpp:18-25).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Optional, Union

import numpy as np

from ice_halo_sim_jax.config.loader import load_project, load_project_file
from ice_halo_sim_jax.config.schema import ProjectConfig, RenderConfig
from ice_halo_sim_jax.engine.simulator import DEFAULT_GEOM_CLOCK, Engine, Stats

# Render fields whose change requires NO re-simulation (appearance pass only;
# reference render_config.hpp NeedsRebuild == false set).
_APPEARANCE_FIELDS = (
    "background",
    "ray_color",
    "opacity",
    "intensity_factor",
    "central_grid",
    "elevation_grid",
    "celestial_outline",
)


class SimState(enum.Enum):
    IDLE = "idle"
    RUNNING = "running"
    STOPPED = "stopped"


@dataclasses.dataclass(frozen=True)
class ResultFrame:
    """Immutable result snapshot (reference ResultFrame, server.hpp:229-242)."""

    generation: int
    ray_count: int
    images: tuple          # per renderer: uint8 [H, W, 3]
    raw_xyz: tuple         # per renderer: float32 [H, W, 3]
    composites: tuple      # per renderer: float [H, W, 3] or None
    stats: Stats
    is_idle: bool
    timestamp: float
    landed: tuple = ()     # per renderer: total landed weight (the
    #                        snapshot_intensity anchor, render.cpp:482)
    ev_auto: tuple = ()    # per renderer: adaptive-brightness EV offset


@dataclasses.dataclass(frozen=True)
class ColorClassDisplay:
    """Display-time appearance of one color class (the mutable subset of
    LUMICE_ColorClassDisplay: color/visible/solo change without
    re-simulation; match/combine are structural)."""

    color: tuple
    visible: bool = True
    solo: bool = False


@dataclasses.dataclass(frozen=True)
class DrainStatus:
    """Consumer-side drain status (LUMICE_GetDrainStatus contract): totals
    are final once drained_epoch == current_epoch."""

    current_epoch: int
    drained_epoch: int


def _layout_key(cfg: ProjectConfig):
    """Config with appearance-only render fields masked to fixed values."""
    renders = tuple(
        dataclasses.replace(
            r,
            background=(0.0, 0.0, 0.0),
            ray_color=(-1.0, -1.0, -1.0),
            opacity=1.0,
            intensity_factor=1.0,
            central_grid=(),
            elevation_grid=(),
            celestial_outline=True,
        )
        for r in cfg.renders
    )
    return dataclasses.replace(cfg, renders=renders)


class Server:
    """Commit-and-poll renderer server.

    One background pump thread advances the active Engine one batch at a
    time until the committed ray budget is met (ray_num < 0 = run forever).
    """

    def __init__(self, seed: Optional[int] = None, batch_size: Optional[int] = None,
                 geom_clock: Optional[int] = None):
        from ice_halo_sim_jax.utils import env_knobs
        from ice_halo_sim_jax.utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        self._seed = seed if seed is not None else env_knobs.get("IHT_SEED", 1)
        self._batch_size = (
            batch_size if batch_size is not None
            else env_knobs.get("IHT_BATCH_SIZE")
        )
        self._geom_clock = (
            geom_clock if geom_clock is not None
            else env_knobs.get("IHT_GEOM_CLOCK", DEFAULT_GEOM_CLOCK)
        )
        # Pump batches between implicit stat drains: bounds the pending
        # device-counter lists on infinite runs (each pump batch appends
        # two small device arrays until someone calls drain_stats).
        self._snapshot_every = int(env_knobs.get("IHT_SNAPSHOT_EVERY", 64))
        self._since_drain = 0
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._engine: Optional[Engine] = None
        self._cfg: Optional[ProjectConfig] = None
        self._generation = 0
        self._target_rays: Optional[int] = 0   # None = infinite
        self._composite_ev = 0.0               # display-time composite EV
        self._shutdown = False
        self._thread = threading.Thread(target=self._pump, daemon=True,
                                        name="iht-server-pump")
        self._thread.start()

    # -- commit protocol ----------------------------------------------------

    def commit(self, config: Union[ProjectConfig, dict, str]) -> bool:
        """Commit a scene (ProjectConfig, dict, JSON text, or a file path).
        Returns True if the previous accumulation was reused (value-equal
        layout), False if simulation restarted."""
        if isinstance(config, str):
            if config.lstrip().startswith("{"):
                import json as _json

                cfg = load_project(_json.loads(config))
            else:
                cfg = load_project_file(config)
        elif isinstance(config, dict):
            cfg = load_project(config)
        else:
            cfg = config

        with self._wake:
            if self._shutdown:
                raise RuntimeError("server is shut down")
            reused = False
            if self._cfg is not None and self._engine is not None:
                if cfg == self._cfg:
                    reused = True          # identical: nothing to do
                elif _layout_key(cfg) == _layout_key(self._cfg):
                    # Appearance-only change: keep accumulators, swap config.
                    self._engine.cfg = cfg
                    reused = True
            if not reused:
                bs = self._batch_size
                if bs is None:
                    import jax
                    bs = 1 << 17 if jax.devices()[0].platform == "cpu" else 1 << 20
                self._engine = Engine(cfg, seed=self._seed, batch_size=bs,
                                      geom_clock=self._geom_clock)
                self._generation += 1
            self._cfg = cfg
            rn = cfg.scene.ray_num
            self._target_rays = None if rn < 0 else int(rn)
            self._wake.notify_all()
            return reused

    # -- pump ---------------------------------------------------------------

    def _work_remaining_locked(self) -> bool:
        if self._engine is None:
            return False
        if self._target_rays is None:
            return True
        return self._engine.stats.rays_traced < self._target_rays

    def _pump(self) -> None:
        while True:
            with self._wake:
                while not self._shutdown and not self._work_remaining_locked():
                    self._wake.wait()
                if self._shutdown:
                    return
                engine = self._engine
                engine.run(n_batches=1)
                self._since_drain += 1
                if self._since_drain >= self._snapshot_every:
                    engine.drain_stats()
                    self._since_drain = 0
                self._wake.notify_all()

    # -- results ------------------------------------------------------------

    def acquire_frame(self) -> Optional[ResultFrame]:
        """Immutable snapshot of the current accumulation (None before the
        first commit)."""
        from ice_halo_sim_jax.engine import ev_auto as ev_mod

        with self._lock:
            eng = self._engine
            if eng is None:
                return None
            images = tuple(np.array(i) for i in eng.snapshot())
            raw = tuple(np.array(eng.raw_xyz(r)) for r in range(len(eng.proj_plans)))
            ev_scale = float(2.0 ** self._composite_ev)
            comps = tuple(
                (np.asarray(c, np.float32)
                 if (c := eng.composite(r, display_exposure_scale=ev_scale))
                 is not None else None)
                for r in range(len(eng.proj_plans))
            )
            stats = eng.drain_stats()
            landed = tuple(float(x) for x in np.asarray(eng.accum[-1]))
            evs = tuple(
                ev_mod.ev_auto_for_frame(raw[r], landed[r])
                for r in range(len(raw))
            )
            return ResultFrame(
                generation=self._generation,
                ray_count=stats.rays_traced,
                images=images,
                raw_xyz=raw,
                composites=comps,
                stats=stats,
                is_idle=not self._work_remaining_locked(),
                timestamp=time.time(),
                landed=landed,
                ev_auto=evs,
            )

    def config(self):
        """The committed ProjectConfig (None before the first commit)."""
        with self._lock:
            return self._cfg

    def sim_ray_count(self) -> int:
        with self._lock:
            return 0 if self._engine is None else self._engine.stats.rays_traced

    def state(self) -> SimState:
        with self._lock:
            if self._shutdown:
                return SimState.STOPPED
            return SimState.RUNNING if self._work_remaining_locked() else SimState.IDLE

    def generation(self) -> int:
        with self._lock:
            return self._generation

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until the committed ray budget is drained."""
        deadline = None if timeout is None else time.time() + timeout
        with self._wake:
            while self._work_remaining_locked():
                remaining = None if deadline is None else deadline - time.time()
                if remaining is not None and remaining <= 0:
                    return False
                self._wake.wait(timeout=remaining)
            return True

    # -- display-time color control ------------------------------------------

    def set_raypath_colors(self, displays, z_order=None, mode: Optional[str] = None) -> None:
        """Display-time update of color-class appearance WITHOUT re-simulation
        (LUMICE_SetRaypathColors contract, lumice.h:950): `displays` is a
        sequence of ColorClassDisplay, one per committed class (count must
        match); `z_order`, when given, must be a permutation of
        [0, class_count) assigning each class its new drawing rank; `mode`
        optionally switches the composite mode. All-or-nothing validation."""
        import dataclasses as _dc

        with self._lock:
            if self._engine is None or self._cfg is None:
                raise RuntimeError("no scene committed")
            rc = self._cfg.raypath_color
            classes = rc.classes if rc is not None else ()
            n = len(classes)
            if len(displays) != n:
                raise ValueError(
                    f"class count mismatch: {len(displays)} != committed {n}"
                )
            if z_order is not None:
                if sorted(z_order) != list(range(n)):
                    raise ValueError("z_order must be a permutation of [0, n)")
            if mode is not None and mode not in ("dominant", "additive", "painter"):
                raise ValueError(f"unknown composite mode {mode!r}")
            if rc is None:
                return
            new_classes = tuple(
                _dc.replace(
                    cls,
                    color=tuple(float(x) for x in d.color),
                    visible=bool(d.visible),
                    solo=bool(d.solo),
                    z_order=(int(z_order[i]) if z_order is not None else cls.z_order),
                )
                for i, (cls, d) in enumerate(zip(classes, displays))
            )
            new_rc = _dc.replace(
                rc,
                classes=new_classes,
                composite_mode=mode if mode is not None else rc.composite_mode,
            )
            self._cfg = _dc.replace(self._cfg, raypath_color=new_rc)
            # Display fields only — the engine's structural plan (match bits)
            # is untouched; accumulators are kept.
            self._engine.cfg = self._cfg

    def set_raypath_colors_json(self, text: str) -> None:
        """JSON form of set_raypath_colors (the C-API entry point):
        ``{"classes": [{"color": [r,g,b], "visible": true, "solo": false},
        ...], "z_order": [...], "mode": "dominant"}`` — classes is required,
        z_order/mode optional."""
        import json as _json

        obj = _json.loads(text)
        if not isinstance(obj, dict) or "classes" not in obj:
            raise ValueError('expected {"classes": [...], ...}')
        displays = [
            ColorClassDisplay(
                color=tuple(float(x) for x in d["color"]),
                visible=bool(d.get("visible", True)),
                solo=bool(d.get("solo", False)),
            )
            for d in obj["classes"]
        ]
        self.set_raypath_colors(
            displays, z_order=obj.get("z_order"), mode=obj.get("mode")
        )

    def set_composite_exposure(self, ev_total: float) -> None:
        """Display-time EV for the composite path only (2^ev inside the
        composite bake; mono path unaffected — LUMICE_SetCompositeExposure)."""
        with self._lock:
            self._composite_ev = float(ev_total)

    def color_class_signal(self) -> list:
        """Per-class has-signal flags: 1 iff the class's Y lane has any
        non-zero pixel on any renderer (LUMICE_GetColorClassSignal)."""
        with self._lock:
            eng = self._engine
            if eng is None or not eng.color_classes:
                return []
            flags = [0] * len(eng.color_classes)
            for r in range(len(eng.proj_plans)):
                lanes = eng.lane_y(r)
                if lanes is None:
                    continue
                for c in range(lanes.shape[0]):
                    if flags[c] == 0 and np.any(lanes[c] > 0):
                        flags[c] = 1
            return flags

    def color_overflow_info(self) -> dict:
        """Color-predicate capacity overflow of the most recent commit
        (LUMICE_GetColorOverflowInfo): predicates beyond the component-mask
        bit budget stop producing bits (coloring degrades, never fails)."""
        from ice_halo_sim_jax.engine.simulator import COLOR_PREDICATE_CAP

        with self._lock:
            count = 0 if self._engine is None else getattr(
                self._engine, "color_overflow_count", 0
            )
            return {"component_overflow_count": count,
                    "component_capacity": COLOR_PREDICATE_CAP}

    # -- lifecycle ----------------------------------------------------------

    def drain_status(self) -> DrainStatus:
        """O(1) drain status: totals are final once drained_epoch ==
        current_epoch (LUMICE_GetDrainStatus contract). The epoch is the
        commit generation; it reads as drained when the committed budget is
        traced AND no device work is pending."""
        with self._lock:
            done = not self._work_remaining_locked()
            return DrainStatus(
                current_epoch=self._generation,
                drained_epoch=self._generation if done else self._generation - 1,
            )

    def lifecycle(self) -> dict:
        """Explicit lifecycle + epoch (LUMICE_GetSimLifecycle):
        QueryServerState is a projection of this."""
        with self._lock:
            return {"state": self.state().value, "epoch": self._generation}

    def stop(self) -> None:
        """Stop pumping (keeps state; a new commit restarts). Mirrors
        LUMICE_StopServer semantics: halt work, keep results readable."""
        with self._wake:
            self._target_rays = 0
            self._wake.notify_all()

    def shutdown(self) -> None:
        with self._wake:
            self._shutdown = True
            self._wake.notify_all()
        self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
