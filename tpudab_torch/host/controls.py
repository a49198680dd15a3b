"""Interactive keyboard controls for the live stream dashboard: counterpart
of tpudab.host.controls (a copy with its imports pointed at the port).

Reference parity: the ImGui per-channel controls — play/decode toggles per
service, global play-all/stop-all, volume/mute
(the reference's src/render_radio_block.cpp:145-173,386-408,842-885) — as
single-key commands on the streaming CLI:

  TAB/0-9  select channel        p  toggle play (selected)
  d        toggle decode audio   x  toggle decode data
  a        run all               s  stop all
  +/-      global gain           m  mute toggle
  c        toggle coarse-CFO     [/]  desync threshold -/+
  f/F      fine-freq beta -/+    q  quit
  </>      Band III channel down/up (retune, live tuner only)
  i        toggle inline slideshow images (kitty/sixel/half-block,
           host/termimage.py; reference render_radio_block.cpp:309-384)

Live OFDM tunables (c, [, ], f, F) write the running StreamingRadio's
mirrors of OFDM_Demod::GetConfig() — reference parity with the ImGui
controls editing the demod config while running
(the reference's src/render_radio_block.cpp:213-235). When a ConfigManager
is attached, every change autosaves to the JSON config
(reference main.cpp:16-20).

Non-blocking: poll() drains pending keys; when stdin is not a tty it is a
no-op (CI/pipes). `read_key` is injectable for tests.
"""

from __future__ import annotations

import sys
from typing import Callable, Optional


def _tty_key_reader():
    """Returns (read_key, restore) using termios cbreak mode, or (None, None)
    when stdin is not a tty."""
    if not sys.stdin.isatty():
        return None, None
    import select
    import termios
    import tty

    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    tty.setcbreak(fd)

    def read_key() -> Optional[str]:
        r, _, _ = select.select([sys.stdin], [], [], 0)
        if r:
            return sys.stdin.read(1)
        return None

    def restore() -> None:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)

    return read_key, restore


class KeyController:
    """Maps keys to receiver/audio controls; tracks a selected channel."""

    def __init__(self, receiver, audio,
                 read_key: Optional[Callable[[], Optional[str]]] = None,
                 radio=None, config_manager=None):
        self.receiver = receiver
        self.audio = audio
        self.radio = radio                  # StreamingRadio (live tunables)
        self.config_manager = config_manager
        self.selected = 0
        self.quit = False
        # 'i' toggle: render decoded slideshow images inline in the
        # dashboard (host/termimage.py; reference displays slides via an
        # OpenGL texture cache, render_radio_block.cpp:309-384)
        self.show_slides = False
        self._restore = None
        if read_key is None:
            read_key, self._restore = _tty_key_reader()
        self.read_key = read_key

    def _autosave(self, **kw) -> None:
        if self.config_manager is not None:
            try:
                self.config_manager.set(**kw)
            except AttributeError:
                pass  # key not in RadioConfig: runtime-only tunable

    def close(self) -> None:
        if self._restore is not None:
            self._restore()
            self._restore = None

    # ---- selection helpers ----

    def _channel_ids(self):
        return sorted(self.receiver.channels.keys())

    def selected_id(self) -> Optional[int]:
        ids = self._channel_ids()
        if not ids:
            return None
        self.selected %= len(ids)
        return ids[self.selected]

    # ---- key handling ----

    def handle(self, key: str) -> None:
        r, a = self.receiver, self.audio
        sid = self.selected_id()
        if key == "q":
            self.quit = True
        elif key == "\t":
            self.selected += 1
        elif key.isdigit():
            self.selected = int(key)
        elif key == "a":
            r.run_all()
        elif key == "s":
            r.stop_all()
        elif key == "i":
            self.show_slides = not self.show_slides
        elif key == "m" and a is not None:
            a.muted = not a.muted
        elif key == "+" and a is not None:
            a.global_gain = min(a.global_gain * 1.25, 8.0)
            self._autosave(global_gain=a.global_gain)
        elif key == "-" and a is not None:
            a.global_gain = max(a.global_gain / 1.25, 0.05)
            self._autosave(global_gain=a.global_gain)
        elif key == "c" and self.radio is not None:
            self.radio.is_coarse_freq_correction = \
                not self.radio.is_coarse_freq_correction
            self._autosave(
                is_coarse_freq_correction=self.radio.is_coarse_freq_correction)
        elif key == "[" and self.radio is not None:
            self.radio.desync_threshold = max(
                self.radio.desync_threshold - 0.05, 0.05)
            self._autosave(desync_threshold=self.radio.desync_threshold)
        elif key == "]" and self.radio is not None:
            self.radio.desync_threshold = min(
                self.radio.desync_threshold + 0.05, 1.0)
            self._autosave(desync_threshold=self.radio.desync_threshold)
        elif key == "f" and self.radio is not None:
            self.radio.fine_freq_beta = max(self.radio.fine_freq_beta - 0.05,
                                            0.0)
            self._autosave(fine_freq_beta=self.radio.fine_freq_beta)
        elif key == "F" and self.radio is not None:
            self.radio.fine_freq_beta = min(self.radio.fine_freq_beta + 0.05,
                                            0.99)
            self._autosave(fine_freq_beta=self.radio.fine_freq_beta)
        elif key in "<>" and self.radio is not None \
                and getattr(self.radio, "tuner", None) is not None:
            # click-to-tune analog (render_radio_block.cpp:490-752):
            # step through the Band III channel list and retune
            from tpudab_torch.constants.channels import channel_labels
            labels = channel_labels()
            cur = self.radio.channel
            i = labels.index(cur) if cur in labels else 0
            i = (i + (1 if key == ">" else -1)) % len(labels)
            self.radio.retune(labels[i])
            self._autosave(channel=labels[i])
        elif sid is not None:
            ch = r.channels[sid]
            if key == "p":
                ch.is_play_audio = not getattr(ch, "is_play_audio", True)
            elif key == "d":
                ch.is_decode_audio = not getattr(ch, "is_decode_audio", True)
            elif key == "x":
                ch.is_decode_data = not getattr(ch, "is_decode_data", True)

    def poll(self) -> bool:
        """Drain pending keys; returns False when quit was requested."""
        if self.read_key is not None:
            while True:
                k = self.read_key()
                if not k:
                    break
                self.handle(k)
        return not self.quit

    # ---- dashboard line ----

    def status_line(self) -> str:
        sid = self.selected_id()
        parts = []
        for i, cid in enumerate(self._channel_ids()):
            ch = self.receiver.channels[cid]
            mark = ">" if cid == sid else " "
            flags = "".join([
                "P" if getattr(ch, "is_play_audio", True) else "-",
                "D" if getattr(ch, "is_decode_audio", True) else "-",
                "X" if getattr(ch, "is_decode_data", True) else "-",
            ])
            parts.append(f"{mark}{i}:sub{cid}[{flags}]")
        gain = f"gain={self.audio.global_gain:.2f}" if self.audio else ""
        mute = " MUTED" if (self.audio and self.audio.muted) else ""
        tun = ""
        if self.radio is not None:
            tun = (f" | desync={self.radio.desync_threshold:.2f}"
                   f" beta={self.radio.fine_freq_beta:.2f}"
                   f" coarse={'on' if self.radio.is_coarse_freq_correction else 'OFF'}")
            if getattr(self.radio, "tuner", None) is not None:
                tun += f" ch={self.radio.channel or '?'} </>"
        return (" keys: TAB/sel p/play d/dec x/data a/all s/stop m/mute +/- "
                "c/[/]/f/F q | " + " ".join(parts) + f" {gain}{mute}{tun}")
