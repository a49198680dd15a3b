"""MOT objects and the slideshow (counterpart of tpudab.mot)."""

from tpudab_torch.mot.mot import (MSCDataGroup, parse_msc_data_group,
                                  build_msc_data_group, MOTObject, MOTAssembler,
                                  build_mot_object_groups, ContentType)
from tpudab_torch.mot.slideshow import Slideshow, SlideshowManager
