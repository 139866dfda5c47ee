from . import oracle
