"""Typed offload configuration: one validated object instead of 14 env vars.

The port's copy of ``repro/core/config.py``: the same fields, the same
``SCILIB_*`` names and the same JSON, so a file saved by either package
loads in the other.

The source tool is configured through ``SCILIB_*`` environment knobs —
right for an ``LD_PRELOAD`` interposer on an unmodified CPU binary, but
wrong for a library serving many concurrent workloads: ambient process
state cannot express "this session uses threshold 810, that one a 2 MB
cap", and a recommendation produced by the autotuner could only be
*deployed* by exporting strings.

:class:`OffloadConfig` is the typed replacement.  It is

* **frozen** — a config never mutates; derive with :meth:`replace`,
* **validated** — unknown policies, negative thresholds, bad eviction
  names fail at construction, not deep inside a BLAS call,
* **complete** — every knob that used to live in an env var is a field
  (see :data:`ENV_FIELDS` for the one-to-one mapping),
* **serializable** — :meth:`save`/:meth:`load` round-trip through JSON,
  so ``python -m repro.tools.autotune trace.json --emit-config out.json``
  produces a file a session can run directly,
* **presettable** — :meth:`preset` names the common shapes (``"paper"``,
  ``"throughput"``, ``"low-memory"``).

:meth:`OffloadConfig.from_env` is the **single** environment-ingestion
boundary of the whole package: it layers the ``SCILIB_*`` vars over a
base config with exactly the legacy parsing semantics (lenient — a
malformed value falls back to the base, like the original tool), and it
warns once per process about any ``SCILIB_*`` var it does not recognize,
with the nearest valid name — a typo like ``SCILIB_THRESOLD`` is no
longer silently ignored.  No other module reads ``os.environ``; the
runtime, the memory tiers, the residency engine and the simulator are
all plumbed from a config object.
"""
from __future__ import annotations

import dataclasses
import difflib
import json
import os
import warnings
from typing import Any, Callable, Dict, Mapping, Optional

__all__ = ["OffloadConfig", "ENV_FIELDS", "KNOWN_ENV_VARS", "PRESETS",
           "get_default", "set_default"]

#: config field -> the legacy ``SCILIB_*`` env var it replaces.  This is
#: the documented one-to-one mapping the parity tests assert over.
ENV_FIELDS: Dict[str, str] = {
    "policy": "SCILIB_POLICY",
    "threshold": "SCILIB_THRESHOLD",
    "sync": "SCILIB_SYNC",
    "adaptive": "SCILIB_ADAPTIVE",
    "adaptive_warmup": "SCILIB_ADAPTIVE_WARMUP",
    "callsite": "SCILIB_CALLSITE",
    "dispatch_cache": "SCILIB_DISPATCH_CACHE",
    "devices": "SCILIB_DEVICES",
    "device_bytes": "SCILIB_DEVICE_BYTES",
    "tile_min": "SCILIB_TILE_MIN",
    "evict": "SCILIB_EVICT",
    "pin": "SCILIB_PIN",
    "trace_path": "SCILIB_TRACE",
    "debug": "SCILIB_DEBUG",
    "faults": "SCILIB_FAULTS",
    "retries": "SCILIB_RETRIES",
    "backoff_ms": "SCILIB_BACKOFF_MS",
    "breaker": "SCILIB_BREAKER",
    "breaker_cooldown_ms": "SCILIB_BREAKER_COOLDOWN_MS",
    "pool_bytes": "SCILIB_POOL_BYTES",
    "pool_quota": "SCILIB_POOL_QUOTA",
    "kernel_path": "SCILIB_KERNELS",
    "kernel_block": "SCILIB_KERNEL_BLOCK",
    "precision": "SCILIB_PRECISION",
    "precision_rtol": "SCILIB_PRECISION_RTOL",
    "lapack": "SCILIB_LAPACK",
    "lapack_nb": "SCILIB_LAPACK_NB",
}

#: ``SCILIB_*`` vars that are legitimate but not config fields: kernel
#: backend selection and benchmark knobs read by their own tools.
_NON_CONFIG_VARS = frozenset({"SCILIB_PALLAS", "SCILIB_BENCH_QUICK"})

KNOWN_ENV_VARS = frozenset(ENV_FIELDS.values()) | _NON_CONFIG_VARS

#: valid placement policies (mirrors
#: ``repro_torch.core.policy.POLICY_CLASSES``;
#: asserted in tests so the two cannot drift)
POLICY_NAMES = ("cpu", "counter", "dfu", "memcopy", "pinned")
#: valid eviction policies (mirrors ``repro_torch.core.residency``)
EVICT_NAMES = ("lru", "lfu", "refetch")

#: values of ``SCILIB_PIN`` that mean "pin every placement"
_PIN_ALL = ("never-evict", "all", "1")


# --------------------------------------------------------------------- #
# env parsing (legacy-lenient: malformed values fall back to the base)   #
# --------------------------------------------------------------------- #
_INVALID = object()


def _parse_policy(raw: str):
    return raw if raw in POLICY_NAMES else _INVALID


def _parse_threshold(raw: str):
    try:
        return float(raw)
    except ValueError:
        return _INVALID


def _parse_sync(raw: str):
    return raw == "1"


def _parse_adaptive(raw: str):
    return raw == "1"


def _parse_warmup(raw: str):
    try:
        return max(2, int(raw))
    except ValueError:
        return _INVALID


def _parse_on_unless_zero(raw: str):
    return raw != "0"


def _parse_devices(raw: str):
    try:
        return max(1, int(raw))
    except ValueError:
        return _INVALID


def _parse_device_bytes(raw: str):
    try:
        return int(float(raw))       # "0" = explicit uncapped (-> None)
    except ValueError:
        return _INVALID


def _parse_tile_min(raw: str):
    try:
        return max(1, int(raw))
    except ValueError:
        return _INVALID


def _parse_evict(raw: str):
    low = raw.strip().lower()
    return low if low in EVICT_NAMES else _INVALID


def _parse_pin(raw: str):
    return raw.strip().lower() in _PIN_ALL


def _parse_trace(raw: str):
    return raw


def _parse_debug(raw: str):
    try:
        return int(raw or 0)
    except ValueError:
        return _INVALID


def _parse_faults(raw: str):
    from repro_torch.core.faults import parse_spec
    try:
        parse_spec(raw)
    except ValueError:
        return _INVALID
    return raw


def _parse_retries(raw: str):
    try:
        val = int(raw)
    except ValueError:
        return _INVALID
    return val if val >= 0 else _INVALID


def _parse_nonneg_ms(raw: str):
    try:
        val = float(raw)
    except ValueError:
        return _INVALID
    return val if val >= 0 else _INVALID


def _parse_breaker(raw: str):
    try:
        val = int(raw)
    except ValueError:
        return _INVALID
    return val if val >= 0 else _INVALID


def _parse_kernel_block(raw: str):
    try:
        val = int(raw)
    except ValueError:
        return _INVALID
    return val if val >= 0 else _INVALID


#: valid SCILIB_PRECISION spellings; "native" normalizes to "" (off) so
#: an explicitly-native config stays byte-identical to the default.
PRECISION_NAMES = ("native", "split2", "split3", "auto")


def _parse_precision(raw: str):
    low = raw.strip().lower()
    if low not in PRECISION_NAMES:
        return _INVALID
    return "" if low == "native" else low


def _parse_precision_rtol(raw: str):
    try:
        val = float(raw)
    except ValueError:
        return _INVALID
    return val if 0 < val < 1 else _INVALID


_PARSERS: Dict[str, Callable[[str], Any]] = {
    "policy": _parse_policy,
    "threshold": _parse_threshold,
    "sync": _parse_sync,
    "adaptive": _parse_adaptive,
    "adaptive_warmup": _parse_warmup,
    "callsite": _parse_on_unless_zero,
    "dispatch_cache": _parse_on_unless_zero,
    "devices": _parse_devices,
    "device_bytes": _parse_device_bytes,
    "tile_min": _parse_tile_min,
    "evict": _parse_evict,
    "pin": _parse_pin,
    "trace_path": _parse_trace,
    "debug": _parse_debug,
    "faults": _parse_faults,
    "retries": _parse_retries,
    "backoff_ms": _parse_nonneg_ms,
    "breaker": _parse_breaker,
    "breaker_cooldown_ms": _parse_nonneg_ms,
    "pool_bytes": _parse_device_bytes,
    "pool_quota": _parse_device_bytes,
    "kernel_path": _parse_adaptive,      # "1" enables, like adaptive
    "kernel_block": _parse_kernel_block,
    "precision": _parse_precision,
    "precision_rtol": _parse_precision_rtol,
    "lapack": _parse_adaptive,           # "1" enables, like adaptive
    "lapack_nb": _parse_kernel_block,    # int >= 0 (0 = driver default)
}

#: unknown-var names already warned about (once per process per name)
_WARNED: set = set()


def _warn_unknown(environ: Mapping[str, str]) -> None:
    """Warn (once, with the nearest valid name) on every ``SCILIB_*``
    var :meth:`OffloadConfig.from_env` does not recognize."""
    for var in sorted(environ):
        if not var.startswith("SCILIB_") or var in KNOWN_ENV_VARS:
            continue
        if var in _WARNED:
            continue
        _WARNED.add(var)
        near = difflib.get_close_matches(var, sorted(KNOWN_ENV_VARS), n=1)
        hint = f"; did you mean {near[0]!r}?" if near else ""
        warnings.warn(f"unrecognized environment variable {var!r} is "
                      f"ignored{hint}", stacklevel=3)


# --------------------------------------------------------------------- #
# the config                                                             #
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class OffloadConfig:
    """Every offload-runtime knob, typed and validated.

    ``None`` means "resolve automatically": ``threshold`` falls back to
    the backend-detected default
    (:func:`repro_torch.core.threshold.default_threshold`), ``devices``
    to ``torch.cuda.device_count()`` on the card and 1 on the CPU,
    ``device_bytes`` to uncapped.

    Every field of the reference config is here, so one file or one set
    of ``SCILIB_*`` variables drives both packages.
    """

    policy: str = "dfu"                  # placement policy
    threshold: Optional[float] = None    # N_avg offload threshold
    sync: bool = False                   # block after every call
    adaptive: bool = False               # per-site probe-then-lock mode
    adaptive_warmup: int = 6             # timed probes per site (min 2)
    callsite: bool = True                # call-site fingerprinting
    dispatch_cache: bool = True          # memoized decisions/kernels
    devices: Optional[int] = None        # logical device tiers
    device_bytes: Optional[int] = None   # per-tier residency byte cap
    tile_min: int = 64                   # minimum tile edge for sharding
    evict: str = "lru"                   # cap eviction policy
    pin: bool = False                    # pin every placement
    trace_path: str = ""                 # dump trace here on close/exit
    debug: int = 0                       # 1 = events, 2 = per-call
    # fault tolerance (reference core/faults.py): deterministic
    # injection spec, transient-fault retry, per-device circuit breaker
    faults: str = ""                     # e.g. "transfer:p=0.05,seed=7"
    retries: int = 2                     # retries for transient faults
    backoff_ms: float = 1.0              # base exponential backoff
    breaker: int = 3                     # consecutive failures to trip
    #                                    # a device (0 = breaker off)
    breaker_cooldown_ms: float = 1000.0  # quarantine -> half-open probe
    # multi-tenant shared pool: sessions with pool_bytes set draw on the
    # process-wide SharedDevicePool of that capacity; pool_quota is this
    # session's byte quota inside it (None = fair equal share)
    pool_bytes: Optional[int] = None     # shared-pool capacity (0 = off)
    pool_quota: Optional[int] = None     # this tenant's quota (0 = none)
    # the kernel execution venue (reference kernels/ops.py): race
    # hand-written kernels against the generic offload per call site
    kernel_path: bool = False            # enable the third dispatch venue
    kernel_block: int = 0                # kernel block edge (0 = default)
    # tunable-precision emulation (reference core/precision.py):
    # rewrite fp64 BLAS onto fp32/bf16 split passes with error-bounded
    # escalation.  "" = native (off); "split2"/"split3" force a scheme;
    # "auto" picks per call from the a-priori bound vs precision_rtol.
    precision: str = ""                  # split scheme ("" = native)
    precision_rtol: float = 1e-4         # max accepted relative error
    # the LAPACK solver tier (reference solvers/): route factorizations
    # onto blocked drivers over the BLAS surface, wrap each in a solver
    # span (pinned factor, tagged inner BLAS calls)
    lapack: bool = False                 # intercept the solver tier
    lapack_nb: int = 0                   # LU/Cholesky block size
    #                                    # (0 = driver default)

    # ------------------------------------------------------------------ #
    def __post_init__(self):
        if self.policy not in POLICY_NAMES:
            raise ValueError(f"unknown policy {self.policy!r}; choose "
                             f"from {sorted(POLICY_NAMES)}")
        if self.evict not in EVICT_NAMES:
            raise ValueError(f"unknown eviction policy {self.evict!r}; "
                             f"choose from {sorted(EVICT_NAMES)}")
        if self.threshold is not None:
            object.__setattr__(self, "threshold", float(self.threshold))
            if self.threshold <= 0:
                raise ValueError("threshold must be positive "
                                 f"(got {self.threshold})")
        if self.adaptive_warmup < 2:
            raise ValueError("adaptive_warmup must be >= 2 "
                             f"(got {self.adaptive_warmup})")
        if self.devices is not None and self.devices < 1:
            raise ValueError(f"devices must be >= 1 (got {self.devices})")
        if self.device_bytes is not None:
            if self.device_bytes < 0:
                raise ValueError("device_bytes must be >= 0 "
                                 f"(got {self.device_bytes})")
            if self.device_bytes == 0:    # explicit "uncapped" sentinel
                object.__setattr__(self, "device_bytes", None)
        if self.tile_min < 1:
            raise ValueError(f"tile_min must be >= 1 (got {self.tile_min})")
        if self.debug < 0:
            raise ValueError(f"debug must be >= 0 (got {self.debug})")
        if self.faults:
            from repro_torch.core.faults import parse_spec
            parse_spec(self.faults)         # ValueError on a bad spec
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0 (got {self.retries})")
        if self.backoff_ms < 0:
            raise ValueError("backoff_ms must be >= 0 "
                             f"(got {self.backoff_ms})")
        object.__setattr__(self, "backoff_ms", float(self.backoff_ms))
        if self.breaker < 0:
            raise ValueError(f"breaker must be >= 0 (got {self.breaker})")
        if self.breaker_cooldown_ms < 0:
            raise ValueError("breaker_cooldown_ms must be >= 0 "
                             f"(got {self.breaker_cooldown_ms})")
        object.__setattr__(self, "breaker_cooldown_ms",
                           float(self.breaker_cooldown_ms))
        for name in ("pool_bytes", "pool_quota"):
            val = getattr(self, name)
            if val is not None:
                if val < 0:
                    raise ValueError(f"{name} must be >= 0 (got {val})")
                if val == 0:              # explicit "unset" sentinel
                    object.__setattr__(self, name, None)
        if self.kernel_block < 0:
            raise ValueError("kernel_block must be >= 0 "
                             f"(got {self.kernel_block})")
        if self.lapack_nb < 0:
            raise ValueError("lapack_nb must be >= 0 "
                             f"(got {self.lapack_nb})")
        if self.precision == "native":   # explicit spelling of the default
            object.__setattr__(self, "precision", "")
        if self.precision not in ("", "split2", "split3", "auto"):
            raise ValueError(f"unknown precision {self.precision!r}; "
                             f"choose from {sorted(PRECISION_NAMES)}")
        if not 0 < self.precision_rtol < 1:
            raise ValueError("precision_rtol must be in (0, 1) "
                             f"(got {self.precision_rtol})")
        object.__setattr__(self, "precision_rtol",
                           float(self.precision_rtol))

    # ------------------------------------------------------------------ #
    def replace(self, **kw) -> "OffloadConfig":
        """Derive a new config with some fields changed (re-validated)."""
        return dataclasses.replace(self, **kw)

    def resolved_threshold(self) -> float:
        """The threshold this config actually runs at: the explicit
        value, or the backend-detected default."""
        if self.threshold is not None:
            return self.threshold
        from repro_torch.core import threshold as thr
        return thr.default_threshold()

    def resolved_devices(self, device=None) -> int:
        """The device-tier count this config actually runs at on
        ``device`` (a ``torch.device``; None means the card): the
        explicit value, else one tier per card, and one tier for a
        session on the CPU."""
        if self.devices is not None:
            return self.devices
        if device is not None and device.type == "cpu":
            return 1
        import torch
        return max(1, torch.cuda.device_count())

    # ------------------------------------------------------------------ #
    # the single environment-ingestion boundary                           #
    # ------------------------------------------------------------------ #
    @classmethod
    def from_env(cls, base: Optional["OffloadConfig"] = None,
                 environ: Optional[Mapping[str, str]] = None,
                 ) -> "OffloadConfig":
        """Layer the ``SCILIB_*`` env vars over ``base`` (default: the
        process-default config, see :func:`set_default`).

        Parsing is lenient, matching the legacy knobs exactly: an unset
        or empty var leaves the base value; a malformed value falls back
        to the base value rather than raising.  Unknown ``SCILIB_*``
        vars trigger a one-time warning with the nearest valid name.
        """
        env = os.environ if environ is None else environ
        _warn_unknown(env)
        cfg = get_default() if base is None else base
        for field_name, var in ENV_FIELDS.items():
            raw = env.get(var)
            if raw is None or raw == "":
                continue
            parsed = _PARSERS[field_name](raw)
            if parsed is not _INVALID:
                # one field at a time so a parseable-but-invalid value
                # (negative threshold, devices=0 ...) falls back too
                # instead of escaping the boundary as a ValueError
                try:
                    cfg = cfg.replace(**{field_name: parsed})
                    continue
                except ValueError:
                    pass
            if var not in _WARNED:
                _WARNED.add(var)
                warnings.warn(f"malformed {var}={raw!r} ignored; "
                              f"using {getattr(cfg, field_name)!r}",
                              stacklevel=3)
        return cfg

    @classmethod
    def legacy(cls, policy: Optional[str] = None,
               threshold: Optional[float] = None,
               sync: Optional[bool] = None,
               device_bytes: Optional[int] = None) -> "OffloadConfig":
        """Resolve the legacy ``install()`` arguments with their
        historical precedence: ``SCILIB_POLICY``/``SCILIB_THRESHOLD``
        override the arguments, while explicit ``sync``/``device_bytes``
        arguments override their env vars.  ``None`` means "not given":
        the process-default base (:func:`set_default`) supplies it."""
        seed: Dict[str, Any] = {}
        if policy is not None:
            seed["policy"] = policy
        if threshold is not None:
            seed["threshold"] = threshold
        cfg = cls.from_env(get_default().replace(**seed) if seed
                           else get_default())
        over: Dict[str, Any] = {}
        if sync is not None:
            over["sync"] = bool(sync)
        if device_bytes is not None:
            over["device_bytes"] = device_bytes
        return cfg.replace(**over) if over else cfg

    # ------------------------------------------------------------------ #
    # serialization                                                       #
    # ------------------------------------------------------------------ #
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, data: Mapping[str, Any]) -> "OffloadConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - fields)
        if unknown:
            hints = []
            for key in unknown:
                near = difflib.get_close_matches(key, sorted(fields), n=1)
                hints.append(f"{key!r}" + (f" (did you mean {near[0]!r}?)"
                                           if near else ""))
            raise ValueError("unknown config field(s): " + ", ".join(hints))
        return cls(**data)

    def save(self, path: str) -> None:
        """Write the config as JSON (the tune->deploy artifact)."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "OffloadConfig":
        """Load and validate a JSON config file (unknown fields error,
        with the nearest valid name)."""
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise ValueError(f"{path}: expected a JSON object of config "
                             f"fields, got {type(data).__name__}")
        return cls.from_dict(data)

    def env(self) -> Dict[str, str]:
        """The ``SCILIB_*`` assignments equivalent to this config — the
        inverse of :meth:`from_env` for every non-default field.  Kept
        for interop (shell scripts, the autotuner's printed settings)."""
        default = OffloadConfig()
        out: Dict[str, str] = {}
        for field_name, var in ENV_FIELDS.items():
            val = getattr(self, field_name)
            if val == getattr(default, field_name):
                continue
            if isinstance(val, bool):
                if field_name == "pin":
                    out[var] = "never-evict"
                else:
                    out[var] = "1" if val else "0"
            elif isinstance(val, float) and float(val).is_integer():
                out[var] = str(int(val))
            else:
                out[var] = str(val)
        return out

    # ------------------------------------------------------------------ #
    # presets                                                             #
    # ------------------------------------------------------------------ #
    @classmethod
    def preset(cls, name: str) -> "OffloadConfig":
        """A named preset: ``"paper"``, ``"throughput"``, ``"low-memory"``
        (see :data:`PRESETS`)."""
        try:
            return cls(**PRESETS[name])
        except KeyError:
            raise ValueError(f"unknown preset {name!r}; choose from "
                             f"{sorted(PRESETS)}")


#: named presets: field overrides applied on top of the defaults.
#:
#: * ``paper`` — the source paper's conservative GH200 configuration:
#:   DFU at threshold 500, synchronous per-call timing (how Tables 3/5
#:   were measured), uncapped residency.
#: * ``throughput`` — serve-many-calls shape: async dispatch, adaptive
#:   per-site lock-in so steady-state sites skip threshold math, memoized
#:   dispatch cache on.
#: * ``low-memory`` — shared-accelerator shape: a 256 MB per-tier
#:   residency cap with cost-aware ``refetch`` eviction, so one workload
#:   cannot monopolize HBM.
PRESETS: Dict[str, Dict[str, Any]] = {
    "paper": {"policy": "dfu", "threshold": 500.0, "sync": True},
    "throughput": {"policy": "dfu", "adaptive": True,
                   "adaptive_warmup": 6, "sync": False},
    "low-memory": {"policy": "dfu", "device_bytes": 256 << 20,
                   "evict": "refetch"},
}


# --------------------------------------------------------------------- #
# process-default config (what from_env layers env vars over)            #
# --------------------------------------------------------------------- #
_DEFAULT = OffloadConfig()


def get_default() -> OffloadConfig:
    """The process-default base config (all-defaults unless
    :func:`set_default` installed another — e.g. the CI config-file job
    supplying settings from a checked-in JSON file instead of env)."""
    return _DEFAULT


def set_default(config: OffloadConfig) -> OffloadConfig:
    """Install a process-default base config; returns the previous one.
    ``from_env()`` (and so every session opened without a config)
    starts from this instead of the all-defaults config — the env-free way to
    configure a whole process from a file:

        config.set_default(OffloadConfig.load("tuned.json"))
    """
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, config
    return prev
