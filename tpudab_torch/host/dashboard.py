"""Terminal monitoring dashboard: the reference ImGui views as ANSI text.

Counterpart of tpudab.host.dashboard (a copy with its imports pointed at
the port; render_text prints the same screen). Reference parity (the
plugin's Radio_View_Controller): OFDM
state/offsets/counters, service list with audio/data status, per-service
detail (subchannel, protection, bitrate), DB updater stats, per-channel
error flags (Firecode/RS/AU), dynamic labels, slideshow inventory, audio
controls (volume/mute analog: pipeline gain).
"""

from __future__ import annotations

import sys
import time

from tpudab_torch.constants.tables import programme_type_str, language_str

import numpy as np

# rendered-slide cache: {(transport_id, n_bytes, mode): art} — holds only
# the currently displayed slide (see render_text)
_slide_art_cache: dict = {}


def constellation_snr_db(re, im) -> float:
    """SNR estimate from DQPSK constellation phase spread: z^4 folds the
    four points onto one phase (pi); the residual angle spread / 4 is the
    per-component phase noise, SNR ~= -20 log10(sigma_phase)."""
    re = np.asarray(re, np.float64)
    im = np.asarray(im, np.float64)
    z = re + 1j * im
    mag = np.abs(z)
    ok = mag > 1e-9
    if ok.sum() < 8:
        return 0.0
    z4 = (z[ok] / mag[ok]) ** 4
    dev = np.angle(z4 * np.exp(-1j * np.angle(z4.mean())))
    sigma = max(float(dev.std()) / 4.0, 1e-4)
    return float(-20.0 * np.log10(sigma))


def render_constellation(re, im, rows: int = 11, cols: int = 23,
                         half_range: float = 2.0) -> str:
    """Tiny ASCII density scatter of the DQPSK constellation (the
    reference's ImGui scatter, render_radio_block.cpp:887-918)."""
    re = np.asarray(re)
    im = np.asarray(im)
    grid = np.zeros((rows, cols), np.int32)
    xi = np.clip(((re / half_range + 1) * 0.5 * (cols - 1)).astype(int), 0, cols - 1)
    yi = np.clip(((1 - im / half_range) * 0.5 * (rows - 1)).astype(int), 0, rows - 1)
    np.add.at(grid, (yi, xi), 1)
    shades = " .:+*#@"
    peak = max(int(grid.max()), 1)
    out = []
    for r in range(rows):
        row = "".join(shades[min(len(shades) - 1, g * (len(shades) - 1) // peak)]
                      for g in grid[r])
        out.append("|" + row + "|")
    return "\n".join(out)


def render_text(receiver, stats=None, audio=None, width: int = 78,
                controls=None, timers=None) -> str:
    """Build the full status screen as a string (testable, UI-agnostic)."""
    db = receiver.db
    lines = []
    bar = "=" * width
    lines.append(bar)
    e = db.ensemble
    lines.append(f" tpudab | ensemble {e.label or '?'} (0x{e.ensemble_id:04X}) "
                 f"| {e.country}")
    if stats is not None:
        lines.append(
            f" state={getattr(stats, 'state', '-')} "
            f"freq={getattr(stats, 'net_freq_hz', 0.0):+8.1f} Hz "
            f"(coarse {getattr(stats, 'coarse_freq_hz', 0.0):+6.0f} "
            f"fine {getattr(stats, 'fine_freq_hz', 0.0):+7.1f}) "
            f"power={getattr(stats, 'signal_power', 0.0):.3f}")
        lines.append(
            f" frames={getattr(stats, 'total_frames', 0)} "
            f"desync={getattr(stats, 'total_frames_desync', 0)} "
            f"reacq={getattr(stats, 'reacquisitions', 0)} "
            f"timing_adj={getattr(stats, 'timing_adjustments', 0)} "
            f"snr~{getattr(stats, 'snr_db', 0.0):.1f} dB")
        cre = getattr(stats, "const_re", None)
        if cre is not None and getattr(stats, "const_im", None) is not None:
            lines.append(" constellation:")
            lines.extend("   " + l for l in render_constellation(
                cre, getattr(stats, "const_im")).split("\n"))
    fibs = receiver.stats.get("fibs", 0)
    errs = receiver.stats.get("fib_crc_errors", 0)
    rate = 100.0 * (1 - errs / fibs) if fibs else 0.0
    lines.append(f" FIC: {fibs} FIBs, {errs} CRC errors ({rate:.1f}% ok)")
    if receiver.updater.misc.datetime_utc:
        lines.append(f" time: {receiver.updater.misc.datetime_utc}")
    lines.append(bar)
    lines.append(f" {'SId':>6} {'label':<17}{'PTy':<15}{'lang':<10}"
                 f"{'sub':>3} {'prot':<8}{'kbps':>4} {'type':<5} status")
    for sid, svc in sorted(db.services.items()):
        for comp in db.components_of(sid):
            sub = db.subchannels.get(comp.subch_id) if comp.subch_id is not None else None
            ch = receiver.channels.get(comp.subch_id)
            status = ""
            label_extra = ""
            if ch is not None:
                st = getattr(ch, "stats", {})
                if comp.is_dab_plus:
                    status = (f"sf={st.get('superframes', 0)} "
                              f"fc!{st.get('firecode_errors', 0)} "
                              f"rs!{st.get('rs_errors', 0)} "
                              f"au!{st.get('au_errors', 0)}")
                    hdr = getattr(ch, "last_header", None)
                    if hdr is not None:
                        from tpudab_torch.constants.tables import aac_profile_str
                        label_extra = (f"{hdr.sampling_rate // 1000}kHz "
                                       f"{aac_profile_str(bool(hdr.sbr_flag), bool(hdr.ps_flag))}")
                else:
                    status = (f"fr={st.get('frames', 0)} "
                              f"sync!{st.get('sync_errors', 0)}")
                dl = getattr(ch, "dynamic_label", "")
                if dl:
                    label_extra += f' "{dl}"'
            kind = ("DAB+" if comp.is_dab_plus else
                    "DAB" if comp.is_audio else "data")
            lines.append(
                f" 0x{sid:04X} {svc.label:<17}"
                f"{programme_type_str(svc.programme_type):<15.15}"
                f"{language_str(svc.language):<10.10}"
                f"{comp.subch_id if comp.subch_id is not None else '-':>3} "
                f"{(sub.protection_label if sub else '?'):<8}"
                f"{(sub.bitrate_kbps if sub else 0) or 0:>4} {kind:<5} "
                f"{status} {label_extra}")
    # linked-service tables (FIG 0/6 linkage + FIG 0/21 frequencies): the
    # reference's per-service linked FM/RDS and DRM tables
    # (the reference's src/render_radio_block.cpp:490-752)
    if db.fm_services or db.drm_services or db.link_services:
        lines.append(" linked services:")
        for lsn, link in sorted(db.link_services.items()):
            flags = "".join(["A" if link.active else "-",
                             "H" if link.hard else "S",
                             "I" if link.international else "-"])
            sid = f" sid=0x{link.service_id:04X}" if link.service_id else ""
            lines.append(f"   LSN {lsn:<5} [{flags}]{sid}")
        for pi, fm in sorted(db.fm_services.items()):
            freqs = " ".join(f"{f / 1e6:.1f}MHz" for f in fm.frequencies)
            lines.append(f"   FM  RDS PI 0x{pi:04X}  LSN {fm.link_session}"
                         f"  {freqs}")
        for did, drm in sorted(db.drm_services.items()):
            freqs = " ".join(f"{f / 1e3:.0f}kHz" for f in drm.frequencies)
            lines.append(f"   DRM id 0x{did:04X}  LSN {drm.link_session}"
                         f"  {freqs}")
    # per-service detail for the selected channel (subchannel geometry —
    # reference detail view tables, render_radio_block.cpp:490-752)
    if controls is not None:
        sel = controls.selected_id()
        if sel is not None:
            sub = db.subchannels.get(sel)
            if sub is not None:
                lines.append(
                    f" subchannel {sel}: start_cu={sub.start_cu} "
                    f"size_cu={sub.size_cu} prot={sub.protection_label} "
                    f"{sub.bitrate_kbps or '?'} kbps "
                    f"fec={getattr(sub, 'fec_scheme', 0)}")
    st = receiver.updater.stats
    lines.append(bar)
    lines.append(f" DB: total={st.total} completed={st.completed} "
                 f"pending={st.pending} updates={st.updates} "
                 f"conflicts={st.conflicts}")
    slides = []
    for ch in receiver.channels.values():
        mgr = getattr(ch, "slideshow", None)
        if mgr is not None:
            slides.extend(mgr.slides)
    if slides:
        lines.append(f" slideshows: " + ", ".join(
            f"{s.name or s.transport_id}({s.image_format} {s.width}x{s.height}"
            f",{len(s.data)}B)" for s in slides[:6]))
    rejected = sum(getattr(getattr(ch, "slideshow", None), "rejected", 0)
                   for ch in receiver.channels.values())
    if rejected:
        lines.append(f" slideshows rejected (corrupt): {rejected}")
    if slides and controls is not None and getattr(controls, "show_slides",
                                                   False):
        # inline image of the most recent slide ('i' toggles; kitty/sixel/
        # half-block per terminal — reference render_radio_block.cpp:309-384).
        # The rendered art is cached per (transport_id, size, mode): the
        # sixel/half-block encoders are Python loops and kitty retransmits
        # the whole PNG — re-rendering an unchanged slide at the dashboard's
        # 4 Hz would compete with the decode for CPU (the reference's LRU
        # texture cache analog, render_radio_block.h:23-27).
        from tpudab_torch.host.termimage import detect_mode, render_slide
        s = slides[-1]
        key = (s.transport_id, len(s.data), detect_mode())
        art = _slide_art_cache.get(key)
        if art is None:
            art = render_slide(bytes(s.data), s.image_format or "png")
            _slide_art_cache.clear()     # keep exactly the current slide
            _slide_art_cache[key] = art
        if art:
            lines.append(f" slide: {s.name or s.transport_id}")
            lines.append(art)
    if audio is not None:
        lines.append(f" audio: sink={audio.sink_rate} Hz "
                     f"gain={audio.global_gain:.2f} "
                     f"sources={len(audio._sources)}"
                     + (" MUTED" if getattr(audio, "muted", False) else ""))
    if timers is not None and timers.totals:
        # per-stage wall time (host/profiling.StageTimer): where the loop
        # spends its milliseconds
        parts = []
        for name, e in sorted(timers.summary().items(),
                              key=lambda kv: -kv[1]["seconds"]):
            ms = 1e3 * e["seconds"] / max(e["calls"], 1)
            parts.append(f"{name}={ms:.1f}ms")
        lines.append(" stages: " + " ".join(parts))
    if controls is not None:
        lines.append(controls.status_line())
    lines.append(bar)
    return "\n".join(lines)


class Dashboard:
    """ANSI live view: call update() periodically."""

    def __init__(self, receiver, stats=None, audio=None, out=sys.stdout,
                 min_interval: float = 0.25, controls=None, timers=None):
        self.receiver = receiver
        self.stats = stats
        self.audio = audio
        self.out = out
        self.min_interval = min_interval
        self.controls = controls
        self.timers = timers
        self._last = 0.0

    def update(self, force: bool = False) -> None:
        now = time.time()
        if not force and now - self._last < self.min_interval:
            return
        self._last = now
        text = render_text(self.receiver, self.stats, self.audio,
                           controls=self.controls, timers=self.timers)
        self.out.write("\x1b[2J\x1b[H" + text + "\n")
        self.out.flush()
