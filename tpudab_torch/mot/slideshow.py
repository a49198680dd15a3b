"""Slideshow user application (ETSI TS 101 499) over MOT.

Counterpart of tpudab.mot.slideshow. Each slide keeps transport_id, name,
image subtype, category/slide ids, category title, click-through and
alternative-location URLs, trigger/expire times.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

from tpudab_torch.mot.mot import (MOTObject, MOTAssembler,
                            PARAM_CATEGORY_SLIDE_ID, PARAM_CATEGORY_TITLE,
                            PARAM_CLICK_THROUGH_URL, PARAM_ALT_LOCATION_URL,
                            PARAM_TRIGGER_TIME, PARAM_EXPIRE_TIME)


@dataclasses.dataclass
class Slideshow:
    transport_id: int
    name: str
    subtype: int            # 0 GIF, 1 JFIF, 2 BMP, 3 PNG
    data: bytes
    category_id: int = 0
    slide_id: int = 0
    category_title: str = ""
    click_through_url: str = ""
    alt_location_url: str = ""
    trigger_time: Optional[bytes] = None
    expire_time: Optional[bytes] = None
    width: int = 0          # validated image dimensions (imagemeta probe)
    height: int = 0

    @property
    def image_format(self) -> str:
        return {0: "GIF", 1: "JPEG", 2: "BMP", 3: "PNG"}.get(self.subtype, "?")


class SlideshowManager:
    """Thread-safe collection of decoded slides, keyed by transport id."""

    def __init__(self, max_slides: int = 100):
        self._slides: Dict[int, Slideshow] = {}
        self._order: List[int] = []
        self._lock = threading.Lock()
        self.max_slides = max_slides
        self.rejected = 0   # corrupt/truncated slide bodies (texture.cpp
        #                     parity: stb_image load failure drops the slide)
        self.assembler = MOTAssembler(on_object=self._on_object)

    def push_data_group(self, raw: bytes) -> None:
        self.assembler.push_data_group(raw)

    def _on_object(self, obj: MOTObject) -> None:
        if not obj.is_image:
            return
        # validate the body before accepting: a non-PNG/JPEG or corrupt
        # body is rejected, not shown
        from tpudab_torch.mot.imagemeta import probe_image
        info = probe_image(obj.body)
        if info is None:
            self.rejected += 1
            return
        p = obj.params
        cat = p.get(PARAM_CATEGORY_SLIDE_ID, b"\x00\x00")
        slide = Slideshow(
            transport_id=obj.transport_id,
            name=obj.content_name,
            subtype=obj.content_subtype,
            data=obj.body,
            category_id=cat[0] if len(cat) >= 1 else 0,
            slide_id=cat[1] if len(cat) >= 2 else 0,
            category_title=p.get(PARAM_CATEGORY_TITLE, b"").decode("latin-1", "replace"),
            click_through_url=p.get(PARAM_CLICK_THROUGH_URL, b"").decode("latin-1", "replace"),
            alt_location_url=p.get(PARAM_ALT_LOCATION_URL, b"").decode("latin-1", "replace"),
            trigger_time=p.get(PARAM_TRIGGER_TIME),
            expire_time=p.get(PARAM_EXPIRE_TIME),
            width=info.width,
            height=info.height,
        )
        with self._lock:
            if slide.transport_id not in self._slides:
                self._order.append(slide.transport_id)
            self._slides[slide.transport_id] = slide
            while len(self._order) > self.max_slides:
                evict = self._order.pop(0)
                self._slides.pop(evict, None)

    @property
    def slides(self) -> List[Slideshow]:
        with self._lock:
            return [self._slides[t] for t in self._order]

    def get(self, transport_id: int) -> Optional[Slideshow]:
        with self._lock:
            return self._slides.get(transport_id)
