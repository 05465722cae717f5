"""Small host utilities: environment knobs and injectable clocks."""
