"""Device time of the stream's host-to-device and device-to-host copies,
a frame of the traced stretch."""


def read(s):
  copies = [a for a in s.device if a.kind == 'memcpy'
            and ('HtoD' in a.name or 'DtoH' in a.name)]
  if not copies:
    return None
  return sum(a.end - a.start for a in copies) * 1e-3 / s.iterations
