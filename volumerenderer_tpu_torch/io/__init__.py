from . import ppm
