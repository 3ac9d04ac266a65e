"""The port's drawing layer, in place of matplotlib: a float RGB canvas
(`raster.py`) with a bitmap font (`font.py`) written as PNG (`png.py`),
a PDF writer with vector text, lines and images (`pdf.py`), and the
colours they share (`colors.py`)."""
