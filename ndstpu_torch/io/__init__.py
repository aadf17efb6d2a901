"""Table catalog (ndstpu.io, without the file readers)."""
