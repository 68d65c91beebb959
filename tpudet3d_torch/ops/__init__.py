from .image import (crop_and_resize, crop_and_resize_plain, resize_bilinear,
                    resize_bilinear_plain, resize_weights)

__all__ = ['crop_and_resize', 'crop_and_resize_plain', 'resize_bilinear',
           'resize_bilinear_plain', 'resize_weights']
