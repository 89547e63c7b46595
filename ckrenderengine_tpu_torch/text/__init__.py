"""TrueType text on the host: the font file (``sfnt``), FreeType's
bytecode interpreter (``hinting``) and smooth rasteriser (``raster``),
HarfBuzz's layout as Raqm asks for it (``shaping``), and a face at a size
(``font``), as Pillow draws ``CKSpriteText`` in the reference."""
