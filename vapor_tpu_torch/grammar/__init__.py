from . import letters
